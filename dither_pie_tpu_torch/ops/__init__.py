"""Device-side dither operators: the wavefront error-diffusion path (K1-K3)
and the ordered path (K4)."""
