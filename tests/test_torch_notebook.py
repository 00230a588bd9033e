"""Execute the port's demo notebook (notebook/VideoTransformer_torch_demo.
ipynb) with nbclient, its parameters cell set to the CPU and a tiny
TimeSformer (2 frames at 32², embed 32, 4 heads, 2 layers, fp32): every
cell must run, on a bundled demo clip, and the last must print the
prediction."""

import os

import nbformat
from nbclient import NotebookClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_PATH = os.path.join(REPO, "notebook", "VideoTransformer_torch_demo.ipynb")
CPU_PARAMETERS = f"""device = 'cpu'
dtype = 'float32'
arch = 'timesformer'
num_frames, frame_interval, img_size = 2, 32, 32
embed_dims, num_heads, num_layers = 32, 4, 2
num_class = 400
repo_root = {REPO!r}
video = 'videotransformer_tpu/data/assets/demo/pulse_circle_0.mp4'
ckpt_path = None"""


def test_port_notebook_executes_on_the_cpu(tmp_path, monkeypatch):
    nb = nbformat.read(NB_PATH, as_version=4)
    code = [c for c in nb.cells if c.cell_type == "code"]
    assert "parameters" in code[0].metadata.get("tags", [])
    assert "device = 'cuda'" in code[0].source  # the card by default
    code[0].source = CPU_PARAMETERS
    # the kernel is a child process: the repository goes on its path, and
    # one thread is enough for the tiny model
    prev = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", REPO + (os.pathsep + prev if prev
                                             else ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    NotebookClient(nb, timeout=300, kernel_name="python3", resources={
        "metadata": {"path": str(tmp_path)}}).execute()
    text = "\n".join("".join(out.get("text", "") for out in cell.outputs
                             if out.get("output_type") == "stream")
                     for cell in code)
    assert "prediction:" in text, text
