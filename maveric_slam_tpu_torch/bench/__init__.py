"""The port's profiling tools, on the card: `profile` (the JAX package's
tools/profile_*.py) and `synthetic_accuracy`, each run as
`python -m maveric_slam_tpu_torch.bench.<module>`; `common` holds the
scene, the clocks and the operation counts they share. The port's benchmark
is slam_bench/."""
