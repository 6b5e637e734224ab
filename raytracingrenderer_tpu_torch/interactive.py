"""Interactive render session: fly camera -> film clear -> re-render.

Counterpart of raytracingrenderer_tpu/interactive.py, the headless form
of RTBase's main loop (Main.cpp:74-139): W/A/S/D/Q/E and the arrows move
the camera and clear the accumulated film (rt.clear()), each idle tick
adds one progressive spp, P saves HDR and L saves PNG.  The window is
replaced by files; keys arrive scripted (CLI `-keys w,a,left`) or one a
line on stdin (`-interactive`).  Renders run on the scene's device.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from .config import RenderConfig
from .imaging import film as film_mod
from .render import render, specialize_config
from .scene.controls import FlyCamera
from .scene.types import Scene
from .utils.log import get_logger

MOVE_KEYS = frozenset("wsadqe") | {"left", "right"}


def fly_camera_for(scene: Scene, scene_dir: str) -> FlyCamera:
    """The fly camera of the scene.json from/to/up spec (RTBase seeds
    RTCamera the same way, SceneLoader.h:268-276)."""
    with open(os.path.join(scene_dir, "scene.json")) as f:
        desc = json.load(f)

    def vec(key, default):
        v = desc.get(key)
        if v is None:
            return np.asarray(default, np.float64)
        return np.asarray([float(p) for p in str(v).split()[:3]],
                          np.float64)

    cam = scene.camera
    return FlyCamera(vec("from", (0, 0, 0)), vec("to", (0, 0, 1)),
                     vec("up", (0, 1, 0)), cam.p.cpu().numpy(),
                     cam.width, cam.height)


class InteractiveSession:
    """Camera moves clear the film; steps accumulate progressive spp."""

    def __init__(self, scene: Scene, scene_dir: str,
                 cfg: Optional[RenderConfig] = None):
        # the session traces paths whatever cfg.integrator says, as the
        # JAX package's render does
        self.cfg = specialize_config(dataclasses.replace(
            cfg or RenderConfig(), integrator="path"), scene)
        self.fly = fly_camera_for(scene, scene_dir)
        self.device = scene.device
        self.scene = scene._replace(camera=self.fly.camera(self.device))
        self.film = self._new_film()
        self.log = get_logger("interactive")
        self.running = True
        self.saves = []

    def _new_film(self) -> film_mod.Film:
        return film_mod.new_film(self.fly.height, self.fly.width,
                                 self.device)

    @property
    def spp(self) -> int:
        return int(self.film.spp)

    def key(self, k: str, output: str = "out") -> None:
        """One input event (RTBase Main.cpp:84-131)."""
        k = k.strip().lower()
        if k in MOVE_KEYS:
            self.fly.key(k)
            self.scene = self.scene._replace(
                camera=self.fly.camera(self.device))
            self.film = self._new_film()   # the camera moved: rt.clear()
        elif k == "p":
            from .io.hdr import write_hdr
            path = f"{output}.hdr"
            write_hdr(path, film_mod.to_hdr(self.film).cpu().numpy())
            self.saves.append(path)
            self.log.info("saved %s (%d spp)", path, self.spp)
        elif k == "l":
            from .io.png import write_png
            path = f"{output}.png"
            write_png(path, film_mod.tonemap(self.film).cpu().numpy())
            self.saves.append(path)
            self.log.info("saved %s (%d spp)", path, self.spp)
        elif k in ("esc", "escape", "quit"):
            self.running = False

    def step(self, spp: int = 1) -> film_mod.Film:
        """Accumulate `spp` more progressive samples at the current
        camera (one an idle frame in RTBase)."""
        self.film = render(self.scene, self.cfg, spp=spp, film=self.film)
        return self.film


def run_scripted(scene: Scene, scene_dir: str, cfg: RenderConfig,
                 keys: str, spp_per_tick: int = 1,
                 output: str = "out") -> InteractiveSession:
    """Scripted session: render a tick, apply a key, repeat."""
    s = InteractiveSession(scene, scene_dir, cfg)
    s.step(spp_per_tick)
    for k in keys.split(","):
        if not s.running:
            break
        s.key(k, output=output)
        if s.running and k.strip().lower() in MOVE_KEYS:
            s.step(spp_per_tick)
    return s


def run_stdin(scene: Scene, scene_dir: str, cfg: RenderConfig,
              output: str = "out") -> InteractiveSession:
    """Line-oriented loop: each line is a key (w/s/a/d/q/e/left/right/
    p/l/esc); an empty line renders one more spp."""
    import sys
    s = InteractiveSession(scene, scene_dir, cfg)
    s.step(1)
    s.log.info("interactive: keys w/s/a/d/q/e/left/right, p=save hdr, "
               "l=save png, esc=quit, empty=+1 spp")
    for line in sys.stdin:
        if not s.running:
            break
        k = line.strip()
        if k:
            s.key(k, output=output)
        if s.running:
            s.step(1)
            s.log.info("spp %d", s.spp)
    return s
