"""The ViT-L and ViT-H widths of the torch port held against the JAX package.

fp32 on the CPU, tolerance ``TOL`` = 2e-4 (sums run in another order). ViT-H
has 16 heads of 80 (C 1280) and ViT-L 16 heads of 64 (C 1024); kernels A, B
and C and their backwards take both on the card, where JAX runs its Pallas MLP kernel and, at
head dim 80, XLA attention (``vision_encoder.py`` requires ``hd == 64`` for
its attention kernels). The same arithmetic at narrow widths here:

* the encoder at head dim 80 (hidden 160, two heads, four layers with the
  global ones at 1 and 3, an 8 x 8 grid padded to 9 x 9 under window 3)
  against JAX's ``attn_impl='fused'`` encoder, which takes its XLA attention
  route at that head dim;
* RSPrompter-anchor predict named ``facebook/sam-vit-huge`` with that
  encoder and the ViT-H aggregator's odd hidden states (JAX's
  ``_ARCH_SELECT_LAYERS['huge']``) cut to the tiny depth;
* a 32-layer encoder (ViT-H's depth and global indexes, 80-wide rel-pos
  tables): JAX variables through ``utils/convert.py`` with ``strict=True``,
  and an HF-named SAM file (``vision_encoder.layers.{0..31}``) through both
  packages' ``load_sam_pretrained``;
* the wrappers' width checks, which refuse on any device what the kernels
  do not take (the card tests launch the kernels, forward and backward, at
  these widths; ``test_torch_vit_widths_train.py`` holds the backwards'
  plain versions at head dim 80 and the L/H train steps against JAX).

JAX variables are drawn with numpy on ``jax.eval_shape``'s shapes.
"""

import jax
import numpy as np
import pytest
import torch

from rsprompter_tpu.apis.build import _ARCH_SELECT_LAYERS as JAX_SELECT_LAYERS
from rsprompter_tpu.apis.build import build_detector as jax_build_detector
from rsprompter_tpu.apis.inference import init_detector as jax_init_detector
from rsprompter_tpu.core.config import Config as JaxConfig
from rsprompter_tpu.engine.checkpoint import load_sam_pretrained as jax_load_sam_pretrained
from rsprompter_tpu.utils.torch_convert import load_torch_checkpoint as jax_load_torch_checkpoint
from rsprompter_tpu_torch.apis.build import _ARCH_SELECT_LAYERS, _arch_from_cfg, build_detector
from rsprompter_tpu_torch.apis.inference import inference_detector, init_detector
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.engine import checkpoint as ck
from rsprompter_tpu_torch.models.sam.configs import sam_config
from rsprompter_tpu_torch.ops import fused_mlp as fm
from rsprompter_tpu_torch.ops import fused_vit_attention as fa
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_attn_impl import _encoders_agree
from test_torch_query import _random_variables

TOL = 2e-4
IMAGE = 64
H80 = dict(  # two heads of 80: the 8 x 8 grid pads to 9 x 9 under window 3
    hidden_size=160, num_hidden_layers=4, num_attention_heads=2,
    global_attn_indexes=(1, 3), image_size=IMAGE, patch_size=8, window_size=3,
    output_channels=32,
)
DEEP = dict(H80, num_hidden_layers=32, global_attn_indexes=(7, 15, 23, 31))
ANCHOR = dict(
    type="RSPrompterAnchor", bf16=False, num_classes=3, prompt_shape=(10, 5),
    image_size=IMAGE, hf_sam_pretrain_name="facebook/sam-vit-huge", attn_impl="fused",
    # ViT-H's 16 odd hidden states, cut to the tiny depth
    select_layers=tuple(i for i in _ARCH_SELECT_LAYERS["huge"]
                        if i <= H80["num_hidden_layers"]),
    aggregator_hidden=8, vision_config=H80,
    rpn_strides=(2, 4, 8, 16, 32), roi_strides=(2, 4, 8, 16),
    test_cfg=dict(rpn=dict(nms_pre=50, max_per_img=20, pre_nms_total=60),
                  rcnn=dict(score_thr=0.0, nms_iou_thr=0.5, max_per_img=8, nms_pre=40)),
)


def test_arch_tables_match_jax():
    """The builder's arch, its aggregator layers and the SAM widths at L/H."""
    assert _ARCH_SELECT_LAYERS == JAX_SELECT_LAYERS
    for arch, (c, depth, heads, d) in {"large": (1024, 24, 16, 64),
                                       "huge": (1280, 32, 16, 80)}.items():
        assert _arch_from_cfg({"hf_sam_pretrain_name": f"facebook/sam-vit-{arch}"}) == arch
        v = sam_config(f"facebook/sam-vit-{arch}").vision_config
        assert (v.hidden_size, v.num_hidden_layers, v.num_attention_heads) == (c, depth, heads)
        assert v.hidden_size // v.num_attention_heads == d and v.mlp_dim == 4 * c
        assert len(_ARCH_SELECT_LAYERS[arch]) == depth // 2


def test_hd80_encoder_matches_jax_fused():
    _encoders_agree(H80, "fused")


def test_huge_anchor_predict_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8) for _ in range(2)]
    cfg = {"model": dict(ANCHOR), "crop_size": (IMAGE, IMAGE)}
    jinf = jax_init_detector(JaxConfig.fromdict(cfg), batch_size=2)
    batch = {"images": np.zeros((2, IMAGE, IMAGE, 3), np.uint8),
             "img_shape": np.full((2, 2), IMAGE, np.int32)}
    shapes = jax.eval_shape(lambda: jinf.model.init(
        {"params": jax.random.PRNGKey(0)}, batch, method="predict"))
    variables = _random_variables(shapes, rng)
    # the inferencer's first call takes these variables for its model's init
    monkeypatch.setattr(type(jinf.model), "init", lambda *a, **k: variables)
    j_preds = jinf(imgs)["predictions"]

    model = init_detector(Config.fromdict(cfg), checkpoint=jax_to_state_dict(variables),
                          device="cpu")
    det = model.model
    assert det.backbone.config.hidden_size // det.backbone.config.num_attention_heads == 80
    assert det.neck_feature_aggregator.select_layers == (1, 3)
    t_preds = inference_detector(model, imgs)
    assert len(j_preds) == len(t_preds) == 2
    for jp, tp in zip(j_preds, t_preds):
        assert len(jp["scores"]) > 0
        np.testing.assert_allclose(tp["scores"], np.asarray(jp["scores"]), atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(tp["labels"], np.asarray(jp["labels"]))
        np.testing.assert_allclose(
            tp["bboxes"], np.asarray(jp["bboxes"], np.float32).reshape(-1, 4),
            atol=1e-2, rtol=TOL,  # pixel coordinates up to 64
        )
        assert tp["masks"].shape == jp["masks"].shape
        # thresholded masks: a few boundary pixels may sit within rounding of 0.5
        assert (tp["masks"] != jp["masks"]).mean() < 1e-3


@pytest.fixture(scope="module")
def deep():
    """JAX's 32-layer anchor detector's variables on eval_shape's shapes, and
    the port's detector loaded from them."""
    cfg = dict(ANCHOR, vision_config=DEEP, select_layers=_ARCH_SELECT_LAYERS["huge"])
    model = jax_build_detector(dict(cfg))
    batch = {"images": np.zeros((2, IMAGE, IMAGE, 3), np.uint8),
             "img_shape": np.full((2, 2), IMAGE, np.int32)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch, method="predict"))
    variables = _random_variables(shapes, np.random.default_rng(1))
    port = build_detector(dict(cfg))
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    return dict(cfg=cfg, variables=variables, port=port)


def test_deep_encoder_converts_strict(deep):
    """Every layer of 32 and its 80-wide tables arrive under HF's names."""
    sd = deep["port"].state_dict()
    layers = {int(k.split(".")[2]) for k in sd if k.startswith("backbone.layers.")}
    assert layers == set(range(32))
    assert sd["backbone.layers.31.attn.rel_pos_h"].shape == (2 * 8 - 1, 80)  # global: grid 8
    assert sd["backbone.layers.30.attn.rel_pos_w"].shape == (2 * 3 - 1, 80)  # window 3
    assert len(deep["port"].neck_feature_aggregator.downconvs) == 16
    params = deep["variables"]["params"]["backbone"]["layers_31"]["attn"]
    np.testing.assert_array_equal(sd["backbone.layers.31.attn.rel_pos_h"].numpy(),
                                  params["rel_pos_h"])


def test_deep_hf_file_loads_as_jax(deep, tmp_path):
    """A seeded HF-named SAM file with ``vision_encoder.layers.{0..31}``: both
    loaders fill every SAM tensor, and bitwise the same."""
    rng = np.random.default_rng(2)
    own = deep["port"].state_dict()
    hf = {}
    for prefix, hf_prefix in ck.SAM_SUBTREE_PREFIXES["RSPrompterAnchor"].items():
        for name, t in own.items():
            if name.startswith(prefix):
                hf[hf_prefix + name[len(prefix):]] = torch.from_numpy(
                    rng.standard_normal(tuple(t.shape)).astype(np.float32))
    assert {f"vision_encoder.layers.{i}.attn.qkv.weight" for i in range(32)} <= set(hf)
    path = tmp_path / "pytorch_model.bin"
    torch.save(hf, path)
    params, jax_report = jax_load_sam_pretrained(
        deep["variables"]["params"], jax_load_torch_checkpoint(str(path)), "RSPrompterAnchor",
        verbose=False)
    ref = jax_to_state_dict({**deep["variables"],
                             "params": jax.tree_util.tree_map(np.asarray, params)})
    port = build_detector(dict(deep["cfg"]))
    port.load_state_dict(own, strict=True)
    report = ck.load_sam_pretrained(port, ck.load_torch_checkpoint(str(path)),
                                    "RSPrompterAnchor", verbose=False)
    assert report == {k.replace("/", "."): v for k, v in jax_report.items()}
    assert all(v["missing"] == 0 for v in report.values())
    got = port.state_dict()
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        assert torch.equal(got[name].float(), r.float()), name
    assert torch.equal(got["backbone.layers.31.mlp.lin2.weight"],
                       hf["vision_encoder.layers.31.mlp.lin2.weight"])


def _cpu(*shape):
    return torch.zeros(*shape)


@pytest.mark.parametrize("kind,width", [
    ("mlp", (896, 3584)), ("mlp", (1024, 3072)), ("mlp_bwd", (896, 3584)), ("qkv", 96),
    ("qkv_bwd", 96), ("k12", 96), ("attn", 96), ("attn_bwd", 96),
], ids=["A C=896", "A M=3C", "A' C=896", "B d=96", "B' d=96", "K12' d=96", "C d=96",
        "C' d=96"])
def test_wrappers_refuse_other_widths(kind, width):
    """Kernels A and A' take C in (768, 1024, 1280) with M = 4 C; kernels B,
    B', K12', C and C' head dims 64 and 80. Each forward shares its width
    check with its backward, and the checks run before any device check."""
    if kind.startswith("mlp"):
        c, m = width
        with pytest.raises(ValueError, match="unsupported widths"):
            fm._check_mlp_args(_cpu(4, c), _cpu(c), _cpu(c), _cpu(m, c), _cpu(m), _cpu(c, m),
                               _cpu(c))
    elif kind.startswith("qkv"):
        d = width
        with pytest.raises(ValueError, match="head dim"):
            fm._check_qkv_args(_cpu(1, 4, 4, 2 * d), None, None, _cpu(6 * d, 2 * d),
                               _cpu(6 * d), 6)
    elif kind == "k12":
        with pytest.raises(ValueError, match="head dim"):
            fm._head_dim(_cpu(6 * width, 160), 6, "qkv_headmajor")
    else:
        with pytest.raises(ValueError, match="head dim"):
            fa._check_attention_args(_cpu(1, 6, 9, width), _cpu(1, 2, 9, 3), _cpu(1, 2, 9, 3),
                                     (3, 3))
