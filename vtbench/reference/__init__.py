"""Plain PyTorch references of what the benchmark's cells run.

They import nothing of ``videotransformer_tpu_torch`` and nothing of the
JAX package: the models, the train augment and the eval recipe, HOG, the
loss and AdamW are written out here, in float32 with TF32 off
(``precision.Exact``), from the published descriptions as the port's
plain versions implement them (each file names the code it follows). The
random draws of a train step (the augment's and DropPath's) are made here
again from the same seed, on the same kind of generator and in the same
order as the program makes them, so the reference needs nothing the
program made. ``precision.Fp8`` is the control: the same references with
every product's operands rounded to float8.
"""
