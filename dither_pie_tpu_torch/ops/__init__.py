"""Device-side dither operators: the wavefront error-diffusion path."""
