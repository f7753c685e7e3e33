"""The dry-run's per-device counts at full width (``launch/dryrun.py``):
one cell of each family on the single-pod mesh, (data=16, model=16), its
step run as DTensors, against the same step on the global tensors.

A device does at least its even share of the step (the whole over the
256 devices: data, tensor and expert parallelism split the work) and at
most the whole of it (what every device of a group repeats, such as the
norms of a stream that "model" does not shard, or attention whose heads
"model" does not divide, counts in full).  The same holds for the peak of
its temporaries.  The even split that the dry-run used before its step
ran as DTensors sat at the lower bound by construction."""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun

torch.set_num_threads(1)

CELLS = [("granite-8b", "train_4k"), ("qwen3-moe-30b-a3b", "prefill_32k"),
         ("zamba2-1.2b", "decode_32k"), ("xlstm-125m", "train_4k"),
         ("internvl2-76b", "decode_32k"), ("musicgen-large", "prefill_32k")]


@pytest.fixture(scope="module")
def fake_group():
    """The fake-backend default group the meshes are cut from, torn down
    after the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_per_device_work_lies_between_the_even_split_and_the_whole(
        arch, shape, fake_group, tmp_path):
    """bfloat16 at full width and depth: whole / 256 <= per device <=
    whole, for the flops and for the peak of the temporaries."""
    rec = dryrun.run_cell(arch, shape, "single", tmp_path)
    assert rec["status"] == "OK", rec.get("traceback")
    n = rec["n_devices"]
    assert n == 256
    whole = rec["work"]["whole"]
    for key in ("flops", "peak_bytes"):
        dev = rec["work"][key]
        assert whole[key] / n <= dev <= whole[key], (key, dev, whole[key])
    assert rec["memory"]["temp_bytes_per_device"] == rec["work"][
        "peak_bytes"]
