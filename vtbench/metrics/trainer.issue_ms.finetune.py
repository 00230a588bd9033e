"""Mean host ms to issue a train step (``Trainer.train_step`` from call
to return, no synchronize) in the untraced window."""

from vtbench import readers


def read(run):
    return readers.span_ms(run, "vtbench.train_step")
