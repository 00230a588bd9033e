"""Building blocks and initializers of the port."""
