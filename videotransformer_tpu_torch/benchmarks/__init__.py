"""Measuring scripts of the port: the twins of the JAX package's
``benchmarks/`` (trace_step, trace_infer, profile_train, serve_bench,
run_all), on the card by default."""
