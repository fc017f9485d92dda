"""The encoder's ``attn_impl`` routes of the torch port against the JAX package.

fp32 on the CPU, tolerance ``TOL`` = 2e-4 (sums run in another order). The
port's CPU path runs the plain versions of its kernels; the JAX side runs its
Pallas kernels interpreted:

* ``'flash'``: the port's flash route (plain LN1, explicit window partition,
  K12' for qkv, kernel C) against JAX's ``attn_impl='flash'`` encoder, whose
  flash kernels (K10) run with ``pl.pallas_call`` patched to
  ``interpret=True``, as ``tests/test_flash_attention.py`` does;
* three heads of 64: the port's ``'fused'`` route (kernels A, B, C, which
  take any head count) against JAX's odd-head ``'fused'`` path, whose
  per-head kernel (K11) interprets itself on the CPU;
* ``qkv_headmajor_plain`` (K12') against ``fused_qkv_pair`` (K12), which
  interprets itself on the CPU.

Weights are drawn from a seed with numpy on the shapes ``jax.eval_shape``
gives and carried over by ``rsprompter_tpu_torch.utils.convert``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from rsprompter_tpu.models.sam.configs import SamVisionConfig as JaxVisionConfig
from rsprompter_tpu.models.sam.vision_encoder import SamVisionEncoder as JaxEncoder
from rsprompter_tpu.ops.fused_mlp import fused_qkv_pair
from rsprompter_tpu_torch.apis.build import build_detector
from rsprompter_tpu_torch.engine.train_state import build_trainer
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder
from rsprompter_tpu_torch.ops import fused_mlp as fm
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

TOL = 2e-4  # fp32 on both sides; sums run in another order

FLASH_KW = dict(  # two windowed layers (the 8x8 grid pads to 9x9), one global
    hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
    global_attn_indexes=(1,), image_size=128, patch_size=16, window_size=3,
    output_channels=32,
)
ODD_KW = dict(  # three heads of 64; the 4x4 grid pads to 6x6 under window 3
    hidden_size=192, num_hidden_layers=2, num_attention_heads=3,
    global_attn_indexes=(1,), image_size=64, patch_size=16, window_size=3,
    output_channels=32,
)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _random_params(shapes, rng):
    """Kernels N(0, 1/fan_in); rel-pos tables, pos-embed, biases and norms
    N(0, 0.5)."""
    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _encoders_agree(kw, attn_impl):
    rng = np.random.default_rng(0)
    jenc = JaxEncoder(config=JaxVisionConfig(**kw), attn_impl=attn_impl)
    size = kw["image_size"]
    pixels = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0), pixels))
    variables = _random_params(shapes, rng)
    j_neck, j_hidden = jax.jit(jenc.apply)(variables, pixels)

    enc = SamVisionEncoder(SamVisionConfig(**kw), attn_impl=attn_impl)
    enc.load_state_dict(jax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        neck, hidden = enc(torch.from_numpy(pixels))
    assert len(hidden) == kw["num_hidden_layers"] + 1
    np.testing.assert_allclose(neck.numpy(), np.asarray(j_neck), atol=TOL, rtol=TOL)
    for i, (h, jh) in enumerate(zip(hidden, j_hidden)):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=TOL,
                                   err_msg=f"hidden {i}")


def test_flash_encoder_matches_jax_flash(interpret_pallas):
    _encoders_agree(FLASH_KW, "flash")


def test_odd_head_encoder_matches_jax_fused():
    _encoders_agree(ODD_KW, "fused")


def test_qkv_headmajor_matches_fused_qkv_pair():
    rng = np.random.default_rng(1)
    n, s, c, heads3 = 2, 64, 128, 6
    x = rng.standard_normal((n * s, c)).astype(np.float32)
    w = (rng.standard_normal((c, heads3 * 64)) / np.sqrt(c)).astype(np.float32)
    b = rng.standard_normal(heads3 * 64).astype(np.float32)
    ref = jax.jit(fused_qkv_pair, static_argnums=(3, 4))(x, w, b, heads3, n)
    # JAX packs two heads per 128 lanes: (N, heads3/2, S, 128) -> (N, heads3, S, 64)
    ref = np.asarray(ref).reshape(n, heads3 // 2, s, 2, 64).transpose(0, 1, 3, 2, 4)
    got = fm.qkv_headmajor_plain(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                 torch.from_numpy(b), heads3, n)
    np.testing.assert_allclose(got.numpy(), ref.reshape(n, heads3, s, 64), atol=TOL, rtol=TOL)


def test_qkv_headmajor_backward_raises():
    """Nothing trains on the 'flash' route yet: K12' has no backward."""
    x = torch.randn(2 * 10, 64, requires_grad=True)
    y = fm.qkv_headmajor(x, torch.randn(6 * 64, 64), torch.randn(6 * 64), 6, 2)
    assert y.shape == (2, 6, 10, 64)
    with pytest.raises(NotImplementedError, match="flash"):
        y.sum().backward()


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_unknown_attn_impl_raises(attn_impl):
    cfg = dict(type="RSPrompterQuery", vision_config=ODD_KW, attn_impl=attn_impl)
    with pytest.raises(ValueError, match="'fused'.*'flash'"):
        build_detector(cfg)


@pytest.mark.parametrize("model", [
    dict(type="RSPrompterQuery"),
    dict(type="RSPrompterAnchor", attn_impl="flash"),
], ids=["query", "anchor-flash"])
def test_build_trainer_raises_for_later_slices(model):
    with pytest.raises(NotImplementedError):
        build_trainer({"model": dict(model, vision_config=ODD_KW)}, device="cpu")
