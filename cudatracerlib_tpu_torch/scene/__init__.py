from . import bsdf, lights, scene, sensors, shade_pack, shapes, textures  # noqa: F401
