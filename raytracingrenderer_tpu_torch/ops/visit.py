"""Visits of a constants table by blocks of rays, the K=16 contraction
under B4's pair test: CUDA kernel wrappers and their plain torch
versions.

Counterparts of the TPU kernels of scripts/probe_mxu.py,
scripts/probe_mxu2.py and scripts/probe_mxu3.py (Pallas on the TPU's
matrix unit), the measurements that shaped the treelet pair test
(docs/MXU_AB_r5.md).  The kernels are csrc/visit_kernel.cu, written for
Hopper; the entry points that drive them are the modules of
`raytracingrenderer_tpu_torch.probes`.

  visit: per block of R rays (16 feature rows of `feats`, one column per
      ray) a number of visits to a table of n_tiles (16, TT) tiles:
        tile="dynamic":  visit i reads tile (i * 7) % n_tiles;
        tile="static":   every visit reads tile 0;
        tile="batched8": n_visits // 8 steps, step i reads the 8
                         consecutive tiles from 8 * ((i * 7) % (n_tiles
                         // 8)), side by side as one (16, 8 * TT) tile.
      Each visit is out = tile^T @ f, (TT, R), and then
        reduce="min":    the running min over TT per ray;
        reduce="first8": rows 0..7 of out, kept apart, a running min each
                         (only those 8 columns of the tile are needed);
        reduce="mt":     the constant-form Moller-Trumbore epilogue on
                         the quarters [det | tdet | udet | vdet] of TT/4
                         triangles against the ray's running best t,
                         then the running min of the hits' t.
      layout="ray" keeps a ray's features in one thread's registers;
      layout="lane" splits the TT columns over the lanes of a warp and
      takes the min across lanes (the counterpart of
      probe_mxu2.k_rays_major).  The layout changes no value.
      -> (t, o), each (blocks, 8, R): t the running min (3e38 where
      nothing was found), o the sum of the 16 features.  As the probes'
      (blocks * 8, R) outputs, every row of a block is the same except
      for reduce="first8"; here those rows are an `expand` of one row,
      not a copy, and `t.reshape(-1, R)` is the probes' array.
  dot: out = a^T @ b, (16, TT) x (16, R) -> (TT, R) (probe_mxu.py's
      precision check).
  relayout_loop: n_iter rounds of +1 on each element of (n * 32, 128)
      blocks (probe_mxu.py's relayout probe); a reshape moves no data on
      this card, so only the additions remain.

Precision.  "highest": IEEE fp32, K summed left to right with every
product and sum rounded (no FMA), as the kernels sum on the CUDA cores;
the kernels equal the plain versions bit for bit.  "default": TF32, what
XLA gives an f32 dot at DEFAULT precision on a GPU (the TPU's
single-pass bf16 has no counterpart here).  The operands are rounded to
TF32 (round to nearest, ties away from zero: the low 13 mantissa bits
cleared), their products are exact in fp32, and the plain version sums
them left to right; the kernels run them on the tensor cores (the visit
through wgmma, the dot through mma.sync, two k8 steps each), whose
accumulation order and rounding differ.  Their difference
per output is at most TF32_KERNEL_BOUND * sum_k |a_k b_k| (`tf32_scale`
computes that sum, the max of it where a min was taken).

CUDA tensors launch a kernel or raise; CPU tensors take the plain
version.  `launches` counts kernel launches, by kernel name ("visit/<variant>",
"dot/<precision>", "relayout").  Nothing is built at import.

The fp32 min visit (reduce="min", layout="ray", precision="highest", in
the three tile modes) runs 4 rays a thread and splits a tile's columns
over the MIN_WARPS warps of a block, whose mins meet after the last
visit; its tiles come through a ring of `ring_stages` slots in shared
memory (csrc/visit_kernel.cu).  The lane visit takes its tiles through
such a ring too; each lane keeps a running min of each of its warp's
LANE_RAYS rays over its own 4 columns of every visit, and the min across
the lanes is taken once, after the last.  The MT visit (reduce="mt")
runs MT_RAYS rays a thread; the MT_LANES lanes of a ray split a tile's
groups of 4 triangles and take the min of their bests after every visit
(a butterfly of shuffles), so that each holds the next visit against the
same best; its tiles come through the ring.  The first8 visit runs
F8_RAYS rays a thread; the F8_WARPS warps of a block split the visits
(warp w takes visits w, w + F8_WARPS, ...) and meet after the last; each
warp brings in only its visits' 8 columns, through a ring of F8_SLOTS
slots of its own.  The TF32 visit runs on wgmma through a ring of
packed tiles: `visit` hands its kernel a scratch copy of the visited
tiles, rounded, K-major and padded to whole steps of TF32_N triangles
(`tf32_packed_tiles` of them), made anew on every call.  `_smem_bytes`
is the launchers' layout of dynamic shared memory.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .launch import I32, PTR, bind, launch

K = 16                  # feature rows: the contraction depth
ROWS = 8                # output rows per block, as the probes write them
SPAN = 128              # rays per thread block of the kernels
BIG = 3.0e38            # the running min's start and the miss value
DET_EPS = 1e-12
SMEM_MAX = 232448       # dynamic shared memory a block can have (H100)
MIN_WARPS = 8           # column slices (warps a block) of the fp32 min visit
MIN_RAYS = 4            # consecutive rays a thread of it
MAX_STAGES = 3          # tiles its ring holds at most
# what its ring may take of an SM's 228 KB of shared memory (1 KB of which
# is kept back for each block) and leave room for a second block
RING_BUDGET = (228 // 2 - 1) * 1024
# its shared memory beside the ring: the warps' mins and the barriers
MIN_FIXED = MIN_WARPS * SPAN * 4 + 2 * MAX_STAGES * 8
LANE_WARPS = 4          # warps of a block of the lane visit
LANE_RAYS = 16          # rays of a warp of it, a running min each a lane
LANE_SPAN = LANE_WARPS * LANE_RAYS
# its shared memory beside its ring: the block's features and the barriers
LANE_FIXED = LANE_SPAN * K * 4 + 2 * MAX_STAGES * 8
MT_WARPS = 8            # warps of a block of the MT visit
MT_RAYS = 2             # consecutive rays a thread of it
MT_LANES = 8            # lanes that share a ray, each on its own triangles
MT_WARP_RAYS = 32 // MT_LANES * MT_RAYS  # rays of a warp
MT_SPAN = MT_WARPS * MT_WARP_RAYS        # rays of a block
MT_FIXED = 2 * MAX_STAGES * 8  # its shared memory beside its ring: barriers
TF32_STAGES = 8         # tiles the TF32 visit's ring holds at most
TF32_FIXED = 2 * TF32_STAGES * 8  # its shared memory beside its ring
TF32_N = 128            # triangles of its wgmma steps: packed tiles pad to it
F8_RAYS = 4             # consecutive rays a thread of the first8 visit
F8_SPAN = 32 * F8_RAYS  # rays of a block of it
F8_WARPS = 4            # warps of a block: warp w takes visits w, w + 4, ...
F8_SLOTS = 16           # a warp's slots of one tile's 8 columns
# its shared memory: the warps' slots (16 x 8 floats) and their barriers,
# the warps' mins
F8_SMEM = F8_WARPS * (F8_SLOTS * (K * ROWS * 4 + 8) + ROWS * F8_SPAN * 4)

# (tile, reduce, layout, precision) of each kernel the probes run, in the
# order of the CUDA launcher's variant ids
VARIANTS = (
    ("dynamic", "min", "ray", "highest"),
    ("dynamic", "min", "ray", "default"),
    ("dynamic", "mt", "ray", "highest"),
    ("static", "min", "ray", "highest"),
    ("dynamic", "first8", "ray", "highest"),
    ("dynamic", "min", "lane", "highest"),
    ("batched8", "min", "ray", "highest"),
)
LANE_TT = 128           # the lane layout holds TT / 32 columns a lane

# Bound on |kernel - plain| of a TF32 output, per unit of sum_k |a_k b_k|
# (exact products of the TF32-rounded operands).  The plain sum of 16
# products in fp32 errs by at most 15 u of that sum (u = 2^-24).  Each
# k8 step of the tensor cores (wgmma, mma.sync) sums 8 products and its
# accumulator input; aligning 9 terms
# to the largest with truncation loses under 1 ulp (2 u) of each, and
# the result is rounded once more: at most 20 u of its terms' magnitude,
# so 40 u over the two k-steps.  55 u in all; 64 u is stated.
TF32_KERNEL_BOUND = 2.0 ** -18


def variant_name(tile: str, reduce: str, layout: str, precision: str) -> str:
    return "-".join((tile, reduce, layout, precision))


# kernel launches since import (or the last reset), by the kernels line's
# names
launches: Dict[str, int] = {
    **{"visit/" + variant_name(*v): 0 for v in VARIANTS},
    "dot/highest": 0, "dot/default": 0, "relayout": 0}
_lib = None


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties away from zero), as
    cvt.rna.tf32.f32 rounds: half an ulp of TF32 (bit 12) is added to
    the magnitude and the low 13 bits are cleared.  Inf and NaN pass."""
    b = x.contiguous().view(torch.int32)
    finite = (b & 0x7F800000) != 0x7F800000
    return torch.where(finite, (b + 0x1000) & ~0x1FFF, b).view(torch.float32)


def _prec(x: torch.Tensor, precision: str) -> torch.Tensor:
    return tf32_round(x) if precision == "default" else x


def _contract(cols: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """cols (16, W), f (B, 16, R) -> (B, W, R): sum over k of
    cols[k, w] * f[b, k, r], left to right, each step rounded."""
    out = cols[0][None, :, None] * f[:, 0][:, None, :]
    for k in range(1, K):
        out = out + cols[k][None, :, None] * f[:, k][:, None, :]
    return out


def _feature_sum(f: torch.Tensor) -> torch.Tensor:
    """f (B, 16, R) -> (B, 1, R), the 16 rows summed left to right."""
    s = f[:, 0]
    for k in range(1, K):
        s = s + f[:, k]
    return s[:, None]


def tile_steps(n_visits: int, n_tiles: int, tile: str) -> List[List[int]]:
    """The tiles each step of a visit loop reads, in order."""
    if tile == "static":
        return [[0]] * n_visits
    if tile == "batched8":
        return [[8 * ((i * 7) % (n_tiles // 8)) + k for k in range(8)]
                for i in range(n_visits // 8)]
    return [[(i * 7) % n_tiles] for i in range(n_visits)]


def _mt_epilogue(out: torch.Tensor, t_b: torch.Tensor) -> torch.Tensor:
    """out (B, TT, R) of one visit, t_b (B, 1, R) the running best ->
    (B, TT/4, R): t of each hit of the TT/4 triangles, BIG elsewhere."""
    q = out.shape[1] // 4
    det, tdet, udet, vdet = (out[:, 0:q], out[:, q:2 * q],
                             out[:, 2 * q:3 * q], out[:, 3 * q:4 * q])
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    ad = det * sgn
    su = udet * sgn
    sv = vdet * sgn
    st = tdet * sgn
    hit = ((ad >= DET_EPS) & (su >= 0.0) & (sv >= 0.0) & (su + sv <= ad)
           & (st > 0.0) & (st < t_b * ad))
    return torch.where(hit, st / torch.where(hit, ad, 1.0), BIG)


def _check_visit(tab: torch.Tensor, feats: torch.Tensor, n_visits: int,
                 n_tiles: int, variant: tuple) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"no visit kernel for (tile, reduce, layout, "
                         f"precision) = {variant}; the probes run "
                         f"{VARIANTS}")
    tile, reduce, layout, _ = variant
    for name, a in (("tab", tab), ("feats", feats)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.dim() != 2 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if feats.device != tab.device:
        raise ValueError(f"feats is on {feats.device}, tab on {tab.device}")
    tt = tab.shape[1]
    if tab.shape[0] % K or tt % 32 or tt == 0:
        raise ValueError(f"tab must be (n * 16, TT) with TT a multiple of "
                         f"32, got {tuple(tab.shape)}")
    if not 1 <= n_tiles <= tab.shape[0] // K or n_visits < 0:
        raise ValueError(f"n_tiles {n_tiles} must be in [1, "
                         f"{tab.shape[0] // K}], n_visits >= 0")
    if tile == "batched8" and n_tiles < 8:
        raise ValueError("tile='batched8' needs n_tiles >= 8")
    if layout == "lane" and tt != LANE_TT:
        raise ValueError(f"layout='lane' is built for TT = {LANE_TT}")
    if feats.shape[0] % K or feats.shape[0] == 0 or feats.shape[1] % SPAN:
        raise ValueError(f"feats must be (blocks * 16, R) with R a multiple "
                         f"of {SPAN}, got {tuple(feats.shape)}")


def visit_plain(tab: torch.Tensor, feats: torch.Tensor, *, n_visits: int,
                n_tiles: int, tile: str = "dynamic", reduce: str = "min",
                layout: str = "ray", precision: str = "highest"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version of `visit` (same contract), on any
    device; the layout changes no value and is only checked."""
    variant = (tile, reduce, layout, precision)
    _check_visit(tab, feats, n_visits, n_tiles, variant)
    blocks, r = feats.shape[0] // K, feats.shape[1]
    f = feats.view(blocks, K, r)
    a, fr = _prec(tab, precision), _prec(f, precision)
    acc = torch.full((blocks, ROWS if reduce == "first8" else 1, r), BIG,
                     dtype=torch.float32, device=tab.device)
    for tiles in tile_steps(n_visits, n_tiles, tile):
        cols = torch.cat([a[j * K:(j + 1) * K] for j in tiles], dim=1)
        if reduce == "first8":
            acc = torch.minimum(acc, _contract(cols[:, :ROWS], fr))
        elif reduce == "mt":
            cand = _mt_epilogue(_contract(cols, fr), acc)
            acc = torch.minimum(acc, cand.amin(dim=1, keepdim=True))
        else:
            acc = torch.minimum(acc, _contract(cols, fr).amin(dim=1,
                                                              keepdim=True))
    shape = (blocks, ROWS, r)
    return acc.expand(shape), _feature_sum(f).expand(shape)


def _check_dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> None:
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', got "
                         f"{precision!r}")
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or x.shape[0] != K or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (16, n) tensor, "
                             f"got {tuple(x.shape)}")
    if a.shape[1] % 16 or b.shape[1] % SPAN:
        raise ValueError(f"a must be (16, TT) with TT a multiple of 16 and "
                         f"b (16, R) with R a multiple of {SPAN}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")


def dot_plain(a: torch.Tensor, b: torch.Tensor,
              precision: str = "highest") -> torch.Tensor:
    """a (16, TT), b (16, R) -> a^T @ b (TT, R), summed left to right
    (after rounding both to TF32 for precision="default")."""
    _check_dot(a, b, precision)
    return _contract(_prec(a, precision), _prec(b, precision)[None])[0]


def tf32_scale(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k |a_k b_k| of `dot_plain(a, b, "default")`, per output: the
    unit of TF32_KERNEL_BOUND."""
    return dot_plain(a.abs(), b.abs(), "default")


def visit_tf32_scale(tab: torch.Tensor, feats: torch.Tensor, *,
                     n_visits: int, n_tiles: int, tile: str = "dynamic",
                     layout: str = "ray") -> torch.Tensor:
    """Per ray the largest sum_k |a_k f_k| over the columns a TF32
    min-visit took its min over, (blocks, 8, R): the unit of
    TF32_KERNEL_BOUND for `visit(..., reduce="min",
    precision="default")` (a min moves by no more than the largest
    change of its terms)."""
    t, _ = visit_plain(-tab.abs(), feats.abs().contiguous(),
                       n_visits=n_visits, n_tiles=n_tiles, tile=tile,
                       reduce="min", layout=layout, precision="default")
    return -t


def _check_relayout(x: torch.Tensor, n_iter: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 128 or x.shape[0] % 32 \
            or not x.is_contiguous():
        raise ValueError(f"x must be contiguous (n * 32, 128) blocks, got "
                         f"{tuple(x.shape)}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")


def relayout_loop_plain(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """n_iter rounds of: each (32, 128) block as one (1, 4096) row, +1,
    and back: probe_mxu.py's relayout loop, step for step."""
    _check_relayout(x, n_iter)
    y = x.view(-1, 32, 128)
    for _ in range(n_iter):
        y = (y.reshape(-1, 1, 32 * 128) + 1.0).reshape(-1, 32, 128)
    return y.reshape(x.shape).clone()


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

# the launchers of csrc/visit_kernel.cu (the stream follows each list)
SIGNATURES = {
    "visit_run": [I32] + [PTR] * 4 + [I32] * 5,
    "visit_tf32": [PTR] * 5 + [I32] * 6,
    "visit_dot": [I32] + [PTR] * 3 + [I32] * 2,
    "visit_relayout": [PTR] * 2 + [I32] * 2,
    "visit_floor": [I32] * 3}


def _library():
    """csrc/visit_kernel.cu's launchers, bound once."""
    global _lib
    if _lib is None:
        _lib = bind("visit_kernel", SIGNATURES)
    return _lib


def _cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")


def _aligned(**tensors: torch.Tensor) -> None:
    """The kernels read 16 bytes a load: raise on a tensor whose first
    element is not 16-byte aligned (a view at an odd offset)."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             f"kernel, its data_ptr is {x.data_ptr():#x}")


def _ring_kernel(layout: str, reduce: str, precision: str
                 ) -> Tuple[int, int, int]:
    """(shared memory beside the ring, least slots, most slots) of a visit
    kernel."""
    if layout == "lane":
        return LANE_FIXED, 1, MAX_STAGES
    if reduce == "mt":
        return MT_FIXED, 1, MAX_STAGES
    if precision == "default":
        return TF32_FIXED, 1, TF32_STAGES
    return MIN_FIXED, 1, MAX_STAGES


def _width(tt: int, precision: str) -> int:
    """Columns of a tile in a visit kernel's ring: TT, or for the TF32
    visit TT padded to whole wgmma steps of TF32_N (with copies of the
    last triangle, which leave a min as it was)."""
    return -(-tt // TF32_N) * TF32_N if precision == "default" else tt


def ring_stages(tt: int, tile: str, layout: str = "ray",
                reduce: str = "min", precision: str = "highest") -> int:
    """Slots of the ring of tiles of a visit kernel, as the launchers
    choose them: as many as fit RING_BUDGET beside the kernel's other
    shared memory (MIN_FIXED, LANE_FIXED, MT_FIXED, TF32_FIXED), so that
    two blocks stay resident on an SM, at most MAX_STAGES (TF32_STAGES for
    the TF32 visit), at least the ones it cannot do without (`_ring_kernel`);
    the static tile is brought in once and needs one.  (A batched step
    goes through the ring as 8 visits of one tile.)  first8's are a warp's
    F8_SLOTS slots of a tile's 8 columns, whatever TT."""
    if reduce == "first8":
        return F8_SLOTS
    if tile == "static":
        return 1
    fixed, least, most = _ring_kernel(layout, reduce, precision)
    slot = K * _width(tt, precision) * 4
    return max(least, min(most, (RING_BUDGET - fixed) // slot))


def _smem_bytes(tt: int, variant: tuple) -> int:
    """Dynamic shared memory of the visit kernel of `variant`: the ring
    and the kernel's other shared memory; first8's, F8_SMEM whatever TT."""
    tile, reduce, layout, precision = variant
    if reduce == "first8":
        return F8_SMEM
    return (ring_stages(tt, tile, layout, reduce, precision) * K
            * _width(tt, precision) * 4
            + _ring_kernel(layout, reduce, precision)[0])


def tf32_packed_tiles(n_visits: int, n_tiles: int) -> int:
    """Tiles of the TF32 visit's packed copy: the distinct tiles its
    visits read in order, (i * 7) % n_tiles repeating every n_tiles /
    gcd(7, n_tiles) visits, at most n_visits."""
    return min(n_visits, n_tiles // math.gcd(7, n_tiles))


def visit(tab: torch.Tensor, feats: torch.Tensor, *, n_visits: int,
          n_tiles: int, tile: str = "dynamic", reduce: str = "min",
          layout: str = "ray", precision: str = "highest"
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tab (n_tiles * 16, TT) f32, feats (blocks * 16, R) f32 -> (t, o),
    each (blocks, 8, R) (module docstring).  CUDA tensors launch the
    kernel of the variant; CPU tensors take `visit_plain`."""
    variant = (tile, reduce, layout, precision)
    _check_visit(tab, feats, n_visits, n_tiles, variant)
    dev = tab.device
    if dev.type == "cpu":
        return visit_plain(tab, feats, n_visits=n_visits, n_tiles=n_tiles,
                           tile=tile, reduce=reduce, layout=layout,
                           precision=precision)
    _cuda(dev, "visit")
    tt = tab.shape[1]
    if _smem_bytes(tt, variant) > SMEM_MAX:
        raise ValueError(f"{_smem_bytes(tt, variant)} bytes of "
                         f"shared memory for TT = {tt}, tile={tile!r}: "
                         f"above the {SMEM_MAX} a block can have")
    _aligned(tab=tab, feats=feats)
    blocks, r = feats.shape[0] // K, feats.shape[1]
    rows = ROWS if reduce == "first8" else 1
    t = torch.empty((blocks, rows, r), dtype=torch.float32, device=dev)
    o = torch.empty((blocks, 1, r), dtype=torch.float32, device=dev)
    if precision == "default":
        n_packed = tf32_packed_tiles(n_visits, n_tiles)
        packed = torch.empty((n_packed * K, _width(tt, precision)),
                             dtype=torch.float32, device=dev)
        launch(_library()["visit_tf32"], dev, tab.data_ptr(),
               packed.data_ptr(), feats.data_ptr(), t.data_ptr(),
               o.data_ptr(), blocks, r, tt, n_tiles, n_visits, n_packed)
    else:
        launch(_library()["visit_run"], dev,
               VARIANTS.index(variant), tab.data_ptr(), feats.data_ptr(),
               t.data_ptr(), o.data_ptr(), blocks, r, tt, n_tiles, n_visits)
    launches["visit/" + variant_name(*variant)] += 1
    shape = (blocks, ROWS, r)
    return t.expand(shape), o.expand(shape)


def dot(a: torch.Tensor, b: torch.Tensor,
        precision: str = "highest") -> torch.Tensor:
    """a (16, TT), b (16, R) -> a^T @ b (TT, R) in fp32 ("highest") or
    TF32 ("default"): CUDA tensors launch the kernel; CPU tensors take
    `dot_plain`."""
    _check_dot(a, b, precision)
    dev = a.device
    if dev.type == "cpu":
        return dot_plain(a, b, precision)
    _cuda(dev, "dot")
    _aligned(a=a, b=b)
    out = torch.empty((a.shape[1], b.shape[1]), dtype=torch.float32,
                      device=dev)
    launch(_library()["visit_dot"], dev,
           int(precision == "default"), a.data_ptr(), b.data_ptr(),
           out.data_ptr(), a.shape[1], b.shape[1])
    launches["dot/" + precision] += 1
    return out


def relayout_loop(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """x (n * 32, 128) f32 -> x after n_iter rounds of +1 per element:
    CUDA tensors launch the kernel; CPU tensors take
    `relayout_loop_plain`."""
    _check_relayout(x, n_iter)
    dev = x.device
    if dev.type == "cpu":
        return relayout_loop_plain(x, n_iter)
    _cuda(dev, "relayout")
    _aligned(x=x)
    out = torch.empty_like(x)
    launch(_library()["visit_relayout"], dev,
           x.data_ptr(), out.data_ptr(), x.numel(), n_iter)
    launches["relayout"] += 1
    return out


FLOOR_KINDS = ("dot/highest", "dot/default", "relayout",
               "visit/dynamic-first8-ray-highest")


def floor_launch(kind: str, n0: int, n1: int = 0, device="cuda") -> None:
    """Launch an empty kernel with the grid and block of `dot(a, b)` for
    a (16, n0), b (16, n1) (kind "dot/highest" or "dot/default"), of
    `relayout_loop` over n0 floats (kind "relayout") or of first8's visit
    over n1 blocks of n0 rays: its time on the device is what the card
    takes for any launch of that size, the floor under those kernels'
    times.  It computes nothing and counts no launch."""
    dev = torch.device(device)
    _cuda(dev, "floor")
    launch(_library()["visit_floor"], dev, FLOOR_KINDS.index(kind), n0, n1)
