"""Data, sequence and tensor parallelism of the port: process groups, the
rank's batch rows and draws and the collectives (``mesh``), a clip's
tokens split over the seq ranks (``sp``), Megatron column and row shards
of the transformer blocks (``tp``)."""
