"""Data and tensor parallelism of the port: process groups, the rank's
batch rows and draws (``mesh``), Megatron column and row shards of the
transformer blocks (``tp``)."""
