"""Scene and image files (port of cudatracerlib_tpu/io): OBJ, PLY, Mitsuba
`.serialized`, hair, MD5 meshes and animations, the Preetham sun and sky,
PNG and npz images, and the Mitsuba XML scene loader."""
