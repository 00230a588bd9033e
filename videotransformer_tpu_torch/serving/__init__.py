"""Serving of the port: a bucketed predictor over a JAX serving artifact
(``predictor``) and the dynamic-batching server (``server``)."""
