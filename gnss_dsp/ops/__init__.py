"""Device-side DSP primitives (jax.numpy / lax)."""
