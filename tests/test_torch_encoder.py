"""SAM ViT encoder of the torch port held against the JAX encoder (fp32, CPU).

The same seeded weights (JAX init, carried over by
``rsprompter_tpu_torch.utils.convert``) and the same numpy input go through
``rsprompter_tpu.models.sam.vision_encoder.SamVisionEncoder`` (``attn_impl=
'xla'``, exact softmax) and the port's encoder, whose CPU path runs the plain
versions of kernels A, B and C. Hidden 128, two heads of 64, three layers:
two windowed (the 10x10 grid pads to 12x12 under window 4) and one global.
"""

import jax
import numpy as np
import pytest
import torch

from rsprompter_tpu.models.sam.configs import SamVisionConfig as JaxVisionConfig
from rsprompter_tpu.models.sam.vision_encoder import SamVisionEncoder as JaxEncoder
from rsprompter_tpu_torch.models.sam.configs import SamVisionConfig
from rsprompter_tpu_torch.models.sam.vision_encoder import SamVisionEncoder
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

VISION_KW = dict(
    hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
    global_attn_indexes=(1,), image_size=160, patch_size=16, window_size=4,
    output_channels=32,
)
TOL = 2e-4  # fp32 on both sides; sums run in another order


def _random_tables(params, rng):
    """JAX inits rel-pos tables and pos_embed to zero; fill them so the
    bias and the resize paths are exercised."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("rel_pos_h", "rel_pos_w", "pos_embed"):
                node[k] = rng.standard_normal(v.shape).astype(np.float32) * 0.5
    walk(params)
    return params


@pytest.mark.parametrize("image", [160, 128], ids=["native", "resized-tables"])
def test_encoder_matches_jax(image):
    """``image=128`` feeds an 8x8 grid to tables built for 10x10: the abs
    pos-embed takes the bicubic resize and the global layer's rel-pos tables
    the linear resize, in both implementations."""
    rng = np.random.default_rng(0)
    jcfg = JaxVisionConfig(**VISION_KW)
    jenc = JaxEncoder(config=jcfg, attn_impl="xla")
    pixels = rng.standard_normal((2, image, image, 3)).astype(np.float32)
    variables = jax.jit(jenc.init)(jax.random.PRNGKey(0), pixels)  # one program, not op by op
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params = _random_tables(jax.tree_util.tree_map(np.array, params), rng)
    j_neck, j_hidden = jax.jit(jenc.apply)({"params": params}, pixels)

    enc = SamVisionEncoder(SamVisionConfig(**VISION_KW))
    enc.load_state_dict(jax_to_state_dict({"params": params}), strict=True)
    with torch.no_grad():
        neck, hidden = enc(torch.from_numpy(pixels))

    assert len(hidden) == VISION_KW["num_hidden_layers"] + 1
    np.testing.assert_allclose(neck.numpy(), np.asarray(j_neck), atol=TOL, rtol=TOL)
    for i, (h, jh) in enumerate(zip(hidden, j_hidden)):
        np.testing.assert_allclose(
            h.numpy(), np.asarray(jh), atol=TOL, rtol=TOL, err_msg=f"hidden {i}"
        )


@pytest.mark.parametrize("grad", [False, True], ids=["frozen", "takes-grad"])
def test_kernel_route_operand_dtype(grad, monkeypatch):
    """Off the CPU, an fp32 encoder that takes no gradient (SAM-det's frozen
    segmentor, every predict) hands fp32 operands to kernels A, B and C with
    no bf16 cast; one that takes gradients hands them bf16 (the backward
    kernels take bf16 only). Meta tensors stand in for the card: stubs in
    place of the three wrappers record what they are given and return the
    plain versions' results."""
    from rsprompter_tpu_torch.ops import fused_mlp as fm
    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    seen = []

    def stub(name, plain):
        def fn(*args):
            seen.append((name, args[0].dtype, args[0].device.type))
            return plain(*args)
        return fn

    monkeypatch.setattr(fm, "ln_qkv_headmajor", stub("B", fm.ln_qkv_headmajor_plain))
    monkeypatch.setattr(fa, "relpos_attention", stub("C", fa.relpos_attention_plain))
    monkeypatch.setattr(fm, "ln_mlp_residual", stub("A", fm.ln_mlp_residual_plain))
    enc = SamVisionEncoder(SamVisionConfig(**VISION_KW)).to("meta")
    pixels = torch.empty((1, 160, 160, 3), device="meta")
    with torch.set_grad_enabled(grad):
        neck, hidden = enc(pixels)
    want = torch.bfloat16 if grad else torch.float32
    layers = VISION_KW["num_hidden_layers"]
    assert seen == [(n, want, "meta") for n in ("B", "C", "A")] * layers
    assert all(t.dtype == torch.float32 for t in (neck,) + hidden)
