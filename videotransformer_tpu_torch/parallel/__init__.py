"""Data, sequence, tensor and pipeline parallelism of the port: process
groups, the rank's batch rows and draws and the collectives (``mesh``), a
clip's tokens split over the seq ranks (``sp``), Megatron column and row
shards of the transformer blocks (``tp``), the blocks split by depth into
GPipe stages (``pp``)."""
