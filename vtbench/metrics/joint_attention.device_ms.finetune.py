"""Device ms a traced step of the joint attention's forward in either of
its forms: the port's ``attention.fused`` spans (the fused prenorm-MHSA
call, B1) and ``attention.unfused`` spans (LayerNorm, qkv, the layout
copies, B5, the projection) together, one a layer, from the CUDA events
each span records on the current stream; None where neither was
recorded (a program without the ``attention.fused`` span reads its
unfused spans alone)."""

from vtbench import inside


def read(run):
    got = [inside.device_ms_per_step(run, name)
           for name in ("attention.fused", "attention.unfused")]
    got = [v for v in got if v is not None]
    return sum(got) if got else None
