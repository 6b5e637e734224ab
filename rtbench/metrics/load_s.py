"""load_s: seconds of the renderer's load_scene (the scene's tables and
its BVH), host clock around the call, synchronised."""


def read(record):
    return record.get("load_s")
