"""The port's bench and profiling tools, on the card (the JAX package's
bench.py, bench_all.py and tools/ for the port): `headline`, `suite`,
`scaling`, `profile` and `synthetic_accuracy`, each run as
`python -m maveric_slam_tpu_torch.bench.<module>`; `common` holds the
scene, the clocks and the operation counts they share."""
