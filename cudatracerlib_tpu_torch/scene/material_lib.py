"""Named material library: conductor IORs, measured scattering media, glass
(a copy of cudatracerlib_tpu/scene/material_lib.py; numpy only).

Counterpart of reference ``Engine/MaterialLib.{h,cpp}`` (named measured
material DB: sigma_s/sigma_a/g/eta, MaterialLib.h:16-54) and the conductor
spectra used by BsdfParser. RGB-averaged values from the Mitsuba data tables.
"""
from __future__ import annotations

import numpy as np

# conductor (eta, k) RGB triples
CONDUCTORS = {
    "a-C": ([2.93, 2.25, 1.98], [0.88, 0.79, 0.82]),
    "Ag": ([0.155, 0.116, 0.138], [4.83, 3.12, 2.15]),
    "Al": ([1.66, 0.88, 0.52], [9.22, 6.27, 4.84]),
    "Au": ([0.143, 0.375, 1.44], [3.98, 2.39, 1.60]),
    "Cr": ([4.36, 2.91, 1.65], [5.19, 4.22, 3.75]),
    "Cu": ([0.20, 0.92, 1.10], [3.91, 2.45, 2.14]),
    "Li": ([0.27, 0.19, 0.22], [3.53, 2.30, 1.67]),
    "W": ([4.37, 3.30, 2.99], [3.50, 2.60, 2.27]),
    "Ni": ([2.36, 1.66, 1.47], [4.50, 3.12, 2.74]),
    "Ti": ([2.74, 2.54, 2.27], [3.81, 3.43, 3.04]),
    "Hg": ([2.39, 1.44, 0.91], [6.32, 4.52, 3.46]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),
}

# dielectric IORs (reference IOR table)
IOR = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "water ice": 1.31,
    "fused quartz": 1.458, "pyrex": 1.470, "acrylic glass": 1.49,
    "polypropylene": 1.49, "bk7": 1.5046, "glass": 1.5046,
    "sodium chloride": 1.544, "amber": 1.55, "pet": 1.575,
    "diamond": 2.419, "sapphire": 1.7682, "bromine": 1.661,
}

# measured subsurface media: (sigma_s RGB mm^-1, sigma_a RGB mm^-1, eta)
# (Jensen et al. 2001 table, as the reference's MaterialLibrary carries)
MEDIA = {
    "Apple": ([2.29, 2.39, 1.97], [0.0030, 0.0034, 0.046], 1.3),
    "Chicken1": ([0.15, 0.21, 0.38], [0.015, 0.077, 0.19], 1.3),
    "Chicken2": ([0.19, 0.25, 0.32], [0.018, 0.088, 0.20], 1.3),
    "Cream": ([7.38, 5.47, 3.15], [0.0002, 0.0028, 0.0163], 1.3),
    "Ketchup": ([0.18, 0.07, 0.03], [0.061, 0.97, 1.45], 1.3),
    "Marble": ([2.19, 2.62, 3.00], [0.0021, 0.0041, 0.0071], 1.5),
    "Potato": ([0.68, 0.70, 0.55], [0.0024, 0.0090, 0.12], 1.3),
    "Skimmilk": ([0.70, 1.22, 1.90], [0.0014, 0.0025, 0.0142], 1.3),
    "Skin1": ([0.74, 0.88, 1.01], [0.032, 0.17, 0.48], 1.3),
    "Skin2": ([1.09, 1.59, 1.79], [0.013, 0.070, 0.145], 1.3),
    "Spectralon": ([11.6, 20.4, 14.9], [0.0, 0.0, 0.0], 1.3),
    "Wholemilk": ([2.55, 3.21, 3.77], [0.0011, 0.0024, 0.014], 1.3),
}


def conductor(name: str):
    """(eta, k) RGB arrays for a named conductor (case-insensitive)."""
    for k, v in CONDUCTORS.items():
        if k.lower() == name.lower():
            return np.asarray(v[0], np.float32), np.asarray(v[1], np.float32)
    raise KeyError(f"unknown conductor {name!r}; options: {sorted(CONDUCTORS)}")


def ior(name: str) -> float:
    key = name.lower()
    if key not in IOR:
        raise KeyError(f"unknown IOR name {name!r}; options: {sorted(IOR)}")
    return IOR[key]


def medium(name: str):
    """(sigma_s, sigma_a, eta) for a measured subsurface medium."""
    for k, v in MEDIA.items():
        if k.lower() == name.lower():
            return (np.asarray(v[0], np.float32), np.asarray(v[1], np.float32),
                    float(v[2]))
    raise KeyError(f"unknown medium {name!r}; options: {sorted(MEDIA)}")


def sss_record(name: str, scale: float = 1.0, g: float = 0.0) -> dict:
    """Material record for a measured subsurface medium: a smooth dielectric
    boundary (the medium's eta) with the interior sigma_s/sigma_a attached
    for the BSSRDF random walk (Engine/Material.h:66 GetBSSRDF semantics).
    `scale` converts the table's mm^-1 sigmas to scene units."""
    s, a, eta = medium(name)
    return dict(
        bsdf_type=2,  # DIELECTRIC boundary (scene/bsdf.py tag)
        eta=eta,
        sss=1,
        sss_sigma_s=s * scale,
        sss_sigma_a=a * scale,
        sss_g=g,
    )
