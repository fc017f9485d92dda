"""torch<->flax conversion roundtrip + trained-checkpoint key mapping."""

import numpy as np

import jax
import jax.numpy as jnp

from rsprompter_tpu.models.sam import SamMaskDecoder, SamVisionEncoder
from rsprompter_tpu.models.sam.configs import SamMaskDecoderConfig, SamVisionConfig
from rsprompter_tpu.utils.torch_convert import flax_to_torch, torch_to_flax

TINY = SamVisionConfig(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    image_size=32, patch_size=8, window_size=2, global_attn_indexes=(1,),
    output_channels=32,
)


def _roundtrip(module, *init_args, **init_kwargs):
    # the tree's shapes from a trace of init (no op runs), seeded values on
    # them: the roundtrip must give back every value, whatever it is
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *init_args, **init_kwargs))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), shapes)
    sd = flax_to_torch(params)
    restored, missing, used = torch_to_flax(sd, params)
    assert not missing, missing[:5]
    flat_a = jax.tree_util.tree_leaves(params)
    flat_b = jax.tree_util.tree_leaves(restored)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0)
    return sd


def test_vision_encoder_roundtrip():
    enc = SamVisionEncoder(config=TINY)
    sd = _roundtrip(enc, jnp.zeros((1, 32, 32, 3)))
    # keys follow the HF torch naming
    assert "layers.0.attn.qkv.weight" in sd
    assert "patch_embed.projection.weight" in sd
    assert sd["patch_embed.projection.weight"].shape == (32, 3, 8, 8)  # OIHW


def test_mask_decoder_roundtrip_with_transpose_convs():
    dec = SamMaskDecoder(
        config=SamMaskDecoderConfig(hidden_size=32, num_attention_heads=2, mlp_dim=64)
    )
    b, s, c = 1, 8, 32
    sd = _roundtrip(
        dec,
        jnp.zeros((b, s, s, c)), jnp.zeros((b, s, s, c)),
        jnp.zeros((b, 2, 3, c)), jnp.zeros((b, s, s, c)),
    )
    assert "upscale_conv1.weight" in sd
    # ConvTranspose2d layout (in, out, kh, kw)
    assert sd["upscale_conv1.weight"].shape == (32, 8, 2, 2)
    assert "output_hypernetworks_mlps.0.proj_in.weight" in sd


def test_flatten_linear_mapping():
    """NCHW<->NHWC flatten reorder is self-inverse for conv->linear kernels."""
    rs = np.random.RandomState(0)
    c, h, w, o = 4, 3, 3, 6
    torch_w = rs.randn(o, c * h * w).astype(np.float32)
    flax_tree = {"point_emb_4": {"kernel": jnp.zeros((c * h * w, o))}}
    sd = {"point_emb.4.weight": torch_w}
    restored, missing, _ = torch_to_flax(
        sd, flax_tree, flatten_linears={"point_emb_4": (c, h, w)}
    )
    assert not missing
    back = flax_to_torch(restored, flatten_linears={"point_emb_4": (c, h, w)})
    np.testing.assert_allclose(back["point_emb.4.weight"], torch_w, atol=1e-6)

    # and it actually permutes (not identity)
    plain, _, _ = torch_to_flax(sd, flax_tree)
    assert np.abs(
        np.asarray(plain["point_emb_4"]["kernel"])
        - np.asarray(restored["point_emb_4"]["kernel"])
    ).max() > 0
