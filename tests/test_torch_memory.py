"""``utils/memory.py``: the port's ``oom_guard`` against JAX's on the same
fake predict, and under ``evaluation.loop.evaluate``.

- The same fake batched function, raising ``torch.cuda.OutOfMemoryError``
  above a batch size, is called with the same sequence of batch sizes by
  both guards, and their joined outputs are equal; errors that are not OOM
  propagate at once, and an OOM at ``min_batch`` propagates.
- ``tools.test`` on the CPU at tiny width, with an OOM injected into every
  predict of two images: the guard halves each, and the metrics equal
  those of the run without OOM.
"""

import numpy as np
import pytest
import torch

from rsprompter_tpu.utils import memory as jax_memory
from rsprompter_tpu_torch.utils import memory
from test_torch_eval import _write_config, coco_dir  # noqa: F401  (fixture)


def _fake(calls, limit):
    def fn(scale, batch):
        n = batch["images"].shape[0]
        calls.append(n)
        if n > limit:
            raise torch.cuda.OutOfMemoryError(
                f"CUDA out of memory. Tried to allocate {n} GiB")
        x = batch["images"]
        return (x * scale, {"first": x[:, 0, 0] + batch["shape"][:, 0]})
    return fn


@pytest.mark.parametrize("n,limit,min_batch", [(8, 2, 1), (7, 2, 1), (5, 1, 1), (3, 8, 1),
                                               (7, 2, 4), (6, 0, 1)])
def test_split_sequence_matches_jax(n, limit, min_batch):
    rng = np.random.default_rng(n)
    images = rng.normal(size=(n, 3, 2)).astype(np.float32)
    shape = rng.integers(1, 9, (n, 2)).astype(np.float32)
    port_calls, jax_calls = [], []
    port = memory.oom_guard(_fake(port_calls, limit), min_batch=min_batch)
    ref = jax_memory.oom_guard(_fake(jax_calls, limit), min_batch=min_batch)
    port_batch = {"images": torch.as_tensor(images), "shape": torch.as_tensor(shape)}
    try:
        ref_out = ref(2.0, {"images": images, "shape": shape})
    except Exception as err:  # JAX's guard re-raises the fake's error
        assert memory.is_oom_error(err)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            port(2.0, port_batch)
    else:
        out = port(2.0, port_batch)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref_out[0]))
        np.testing.assert_array_equal(out[1]["first"].numpy(), np.asarray(ref_out[1]["first"]))
        np.testing.assert_array_equal(out[0].numpy(), images * 2)
    assert port_calls == jax_calls


def test_other_errors_propagate():
    calls = []

    def fn(batch):
        calls.append(len(batch["x"]))
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        memory.oom_guard(fn)({"x": torch.zeros(4)})
    assert calls == [4]

    def bad_value(batch):
        raise ValueError("out of memory, but not a RuntimeError")

    with pytest.raises(ValueError):
        memory.oom_guard(bad_value)({"x": torch.zeros(4)})
    assert memory.is_oom_error(RuntimeError("cuBLAS: OUT OF MEMORY"))
    assert not memory.is_oom_error(ValueError("out of memory"))


def test_convert_batch_bf16():
    out = memory.convert_batch_bf16({"a": torch.ones(2), "b": torch.ones(2, dtype=torch.int32),
                                     "c": "meta"})
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == torch.int32
    assert out["c"] == "meta"


def test_evaluate_under_the_guard(coco_dir, tmp_path, monkeypatch, capsys):  # noqa: F811
    from rsprompter_tpu_torch.apis.inference import DetInferencer
    from rsprompter_tpu_torch.tools import test as tool

    cfg = _write_config(tmp_path, coco_dir)
    plain = tool.main([str(cfg), "--device", "cpu"])["metrics"]
    sizes = []
    predict_tensors = DetInferencer.predict_tensors

    def oom_at_two(self, batch):
        sizes.append(batch["images"].shape[0])
        if sizes[-1] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return predict_tensors(self, batch)

    monkeypatch.setattr(DetInferencer, "predict_tensors", oom_at_two)
    guarded = tool.main([str(cfg), "--device", "cpu"])["metrics"]
    assert "oom_guard: CUDA out of memory at batch 2; retrying as 1+1" in capsys.readouterr().out
    assert sizes == [2, 1, 1] * 3  # five images at batch 2: three batches, each halved
    assert guarded.keys() == plain.keys()
    for k in plain:
        assert (np.isnan(plain[k]) and np.isnan(guarded[k])) or guarded[k] == plain[k], k
