"""Ray math: SoA vectors, RNG, intersection, BSDF."""
