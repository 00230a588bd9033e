"""Models of the port: TimeSformer (divided space-time), and the converter
from the JAX package's parameters."""
