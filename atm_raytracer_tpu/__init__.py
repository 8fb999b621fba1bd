"""atm_raytracer_tpu — an atmospheric-refraction panorama renderer in JAX
for the GPU.

A ground-up JAX/XLA re-design of the capabilities of the Rust CLI
``atm-raytracer`` (reference: /root/reference). The reference is an
iterator-and-trait-object pipeline (per-pixel early-exit ray marching on CPU
threads via rayon); this framework is a *dense tensor program with masks*:

* all rays march in lockstep through a batched fixed-step RK4 integrator
  (``physics.ray``), the atmosphere reduced to a compact log-refractivity
  derivative table (``physics.atmosphere``);
* terrain is a device-resident tile mosaic sampled with vectorized bilinear
  gathers (``terrain``);
* the Fast generator's separability (reference src/generator/generators/fast.rs)
  becomes a rank-1 structure: a path tensor [H, N] and a terrain tensor [W, N]
  combined by a dense crossing-detection kernel into fixed-K hit buffers
  (``ops.combine``);
* trait dispatch (Object / ColoringMethod / DirectionalCalc) becomes
  enum-indexed masked arithmetic;
* rayon data parallelism becomes vmap on one device and ``jax.sharding`` across
  devices
  (``parallel``).

Public API mirrors the reference's five subcommands: gen, view, output-atm,
output-ray-paths, output-elev-profile (see ``cli``).
"""

__version__ = "0.1.0"
