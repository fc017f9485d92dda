"""The port's SAM checkpoint loader held against the JAX package's.

A seeded, HF-named SAM state_dict at tiny widths (hidden 32, two layers,
window 3, the 64^2 model's 8 x 8 grid) is written to ``tmp_path`` as
``pytorch_model.bin``; both packages load it into the same detector
parameters: JAX's ``load_sam_pretrained`` into a param tree drawn with numpy
on the shapes ``jax.eval_shape`` gives (the JAX model's own init compiles for
a minute), the port's ``engine.checkpoint.load_sam_pretrained`` into the
port's detector built on the same tree. The results are compared through
``utils/convert.py``: copied tensors bitwise, tensors resized at load time
(a file made at a 16 x 16 grid, as a 1024^2 checkpoint loads into a 512^2
model) within 1e-6. Both families; the HF tie of
``prompt_encoder.shared_embedding``; every SAM parameter filled; the config
key honoured by ``init_detector`` and ``build_trainer`` on the CPU; an
absent file leaving the seeded init as it was.

A reference-trained mmengine file (``{"meta", "state_dict"}`` under the
reference's module names, qkv of mmdet's attentions packed) is made from
the port's seeded state_dict by an inverse map written here, and loaded by
both packages' ``load_reference_checkpoint``: equal through
``utils/convert.py`` exactly, nothing left unfilled in the port.
"""

import re

import jax
import numpy as np
import pytest
import torch

from rsprompter_tpu.apis.build import build_detector as jax_build_detector
from rsprompter_tpu.engine.checkpoint import load_sam_pretrained as jax_load_sam_pretrained
from rsprompter_tpu.utils.torch_convert import load_torch_checkpoint as jax_load_torch_checkpoint
from rsprompter_tpu_torch.apis.build import build_detector, init_random_weights
from rsprompter_tpu_torch.apis.inference import init_detector
from rsprompter_tpu_torch.engine import checkpoint as ck
from rsprompter_tpu_torch.engine.train_state import build_trainer
from rsprompter_tpu_torch.utils.convert import jax_to_state_dict

IMAGE = 64
RESIZE_TOL = 1e-6  # the resizes run in fp32 torch on both sides
VISION = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2, global_attn_indexes=(1,),
    image_size=IMAGE, patch_size=8, window_size=3, output_channels=32,
)
TINY = {
    "RSPrompterAnchor": dict(
        type="RSPrompterAnchor", bf16=False, num_classes=3, prompt_shape=(10, 3),
        image_size=IMAGE, select_layers=(1, 2), aggregator_hidden=8, vision_config=VISION,
        rpn_strides=(2, 4, 8, 16, 32), roi_strides=(2, 4, 8, 16),
    ),
    "RSPrompterQuery": dict(
        type="RSPrompterQuery", bf16=False, num_classes=3, prompt_shape=(6, 5),
        image_size=IMAGE, select_layers=(1, 2), aggregator_hidden=8, vision_config=VISION,
        test_cfg=dict(max_per_image=8),
    ),
}
# the 1024 -> 512 case at tiny width: the file's grid is twice the model's
FILE_GRID = {"native": IMAGE // 8, "resized": 2 * IMAGE // 8}


def _random_tree(shapes, rng):
    return jax.tree_util.tree_map(
        lambda s: (0.5 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


@pytest.fixture(scope="module", params=sorted(TINY))
def family(request):
    """The JAX param tree on eval_shape's shapes, and the port's detector
    on the same values."""
    mtype = request.param
    model = jax_build_detector(dict(TINY[mtype]))
    batch = {"images": np.zeros((2, IMAGE, IMAGE, 3), np.uint8),
             "img_shape": np.full((2, 2), IMAGE, np.int32)}
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, batch, method="predict"))
    rng = np.random.default_rng(0)
    variables = {k: _random_tree(v, rng) for k, v in shapes.items()}
    port = build_detector(dict(TINY[mtype]))
    port.load_state_dict(jax_to_state_dict(variables), strict=True)
    return dict(type=mtype, variables=variables, port=port)


def _hf_state_dict(port, mtype, grid, seed=1):
    """Seeded tensors under the HF SAM names of every SAM parameter of the
    port's detector, pos_embed and the global rel-pos tables made for
    ``grid``; the tied prompt_encoder.shared_embedding left out, as HF saves
    it."""
    rng = np.random.default_rng(seed)
    own = port.state_dict()
    sd = {}
    global_idx = {f"layers.{i}." for i in VISION["global_attn_indexes"]}
    for prefix, hf_prefix in ck.SAM_SUBTREE_PREFIXES[mtype].items():
        for name, t in own.items():
            if not name.startswith(prefix):
                continue
            suffix = name[len(prefix):]
            shape = tuple(t.shape)
            if suffix == "pos_embed":
                shape = (1, grid, grid, shape[3])
            elif suffix.endswith(("rel_pos_h", "rel_pos_w")) and any(
                    suffix.startswith(g) for g in global_idx):
                shape = (2 * grid - 1, shape[1])
            sd[hf_prefix + suffix] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))
    # a tensor of the prompt encoder no family reads, as in a real file
    sd["prompt_encoder.point_embed.0.weight"] = torch.ones(1, 32)
    assert ck.TIED_KEY not in sd
    return sd


def _hf_shape(hf, mtype, name):
    """The shape the file holds for the port's tensor ``name``."""
    for prefix, hf_prefix in ck.SAM_SUBTREE_PREFIXES[mtype].items():
        if name.startswith(prefix):
            return hf[hf_prefix + name[len(prefix):]].shape
    raise KeyError(name)


def _jax_load(family, path):
    params, report = jax_load_sam_pretrained(
        family["variables"]["params"], jax_load_torch_checkpoint(str(path)), family["type"],
        verbose=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    return jax_to_state_dict({**family["variables"], "params": params}), report


def _port_load(family, path):
    port = build_detector(dict(TINY[family["type"]]))
    port.load_state_dict(family["port"].state_dict(), strict=True)
    report = ck.load_sam_pretrained(port, ck.load_torch_checkpoint(str(path)),
                                    family["type"], verbose=False)
    return port.state_dict(), report


@pytest.mark.parametrize("grid", sorted(FILE_GRID))
def test_sam_load_matches_jax(family, tmp_path, grid):
    """Both loaders give the same parameters: SAM tensors from the file
    (bitwise, or within 1e-6 where resized), every other tensor untouched;
    the same per-subtree report, with no SAM parameter left unfilled."""
    hf = _hf_state_dict(family["port"], family["type"], FILE_GRID[grid])
    path = tmp_path / "pytorch_model.bin"
    torch.save(hf, path)
    ref, jax_report = _jax_load(family, path)
    got, report = _port_load(family, path)
    assert got.keys() == ref.keys()
    before = family["port"].state_dict()
    sam = tuple(ck.SAM_SUBTREE_PREFIXES[family["type"]])
    resized = 0
    for name, r in ref.items():
        g = got[name].float()
        if not name.startswith(sam):
            assert torch.equal(g, before[name].float()), name
        elif g.shape == _hf_shape(hf, family["type"], name):
            assert torch.equal(g, r.float()), name
        else:
            resized += 1
            torch.testing.assert_close(g, r.float(), atol=RESIZE_TOL, rtol=RESIZE_TOL)
    assert resized == (0 if grid == "native" else 3)  # pos_embed, rel_pos_h / _w
    assert report == {k.replace("/", "."): v for k, v in jax_report.items()}
    assert report and all(v["missing"] == 0 and v["used"] > 0 for v in report.values())


def test_shared_embedding_tie():
    """The tied key is added from shared_image_embedding where the file
    lacks it, and a file that has it keeps its own."""
    pe = torch.arange(4.0).reshape(2, 2)
    sd = ck.tie_shared_embedding({ck.TIED_SOURCE: pe})
    assert sd[ck.TIED_KEY] is pe
    own = torch.zeros(2, 2)
    assert ck.tie_shared_embedding({ck.TIED_SOURCE: pe, ck.TIED_KEY: own})[ck.TIED_KEY] is own


def test_safetensors_file_reads_as_the_bin(tmp_path):
    from safetensors.torch import save_file

    sd = {"vision_encoder.pos_embed": torch.randn(1, 2, 2, 4), "mask_decoder.x": torch.ones(3)}
    save_file(sd, str(tmp_path / "model.safetensors"))
    torch.save({"state_dict": sd}, tmp_path / "model.pth")
    for name in ("model.safetensors", "model.pth"):
        got = ck.load_torch_checkpoint(str(tmp_path / name))
        assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)


def test_other_families_and_shapes_raise():
    """Every detector family has a SAM map now; a type without one raises,
    as does a tensor of the wrong shape."""
    port = build_detector(dict(TINY["RSPrompterAnchor"]))
    assert {"SAMDet", "SAMSegMaskRCNN", "SAMSegMask2Former"} <= set(ck.SAM_SUBTREE_PREFIXES)
    with pytest.raises(NotImplementedError, match="no SAM checkpoint map"):
        ck.load_sam_pretrained(port, {}, "CascadeRCNN")
    bad = {"vision_encoder.patch_embed.projection.bias": torch.zeros(5)}
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.load_sam_pretrained(port, bad, "RSPrompterAnchor", verbose=False)


def _sam_matches_file(model, hf, mtype):
    for prefix, hf_prefix in ck.SAM_SUBTREE_PREFIXES[mtype].items():
        for name, t in model.state_dict().items():
            if name.startswith(prefix):
                assert torch.equal(t.float(), hf[hf_prefix + name[len(prefix):]]), name


@pytest.mark.parametrize("entry", ["init_detector", "build_trainer"])
def test_entry_points_load_the_config_file(tmp_path, entry):
    """With the config's hf_sam_pretrain_ckpt_path present, the SAM
    parameters are the file's and the rest is the seeded init."""
    mtype = "RSPrompterAnchor"
    port = build_detector(dict(TINY[mtype]))
    hf = _hf_state_dict(port, mtype, FILE_GRID["native"])
    path = tmp_path / "pytorch_model.bin"
    torch.save(hf, path)
    cfg = {"model": dict(TINY[mtype], hf_sam_pretrain_ckpt_path=str(path)),
           "crop_size": (IMAGE, IMAGE)}
    if entry == "init_detector":
        model = init_detector(cfg, device="cpu", seed=0).model
    else:
        model = build_trainer(cfg, device="cpu", seed=0).model
    _sam_matches_file(model, hf, mtype)
    init_random_weights(port, 0)
    name = "neck_feature_aggregator.fusion_conv.0.weight"
    assert torch.equal(model.state_dict()[name], port.state_dict()[name])


def test_absent_file_keeps_the_seeded_init(tmp_path):
    """A config naming a file that is not there gives the same weights as
    one naming none (with a warning), as JAX loads only an existing file."""
    mtype = "RSPrompterAnchor"
    cfg = {"model": dict(TINY[mtype]), "crop_size": (IMAGE, IMAGE)}
    plain = init_detector(cfg, device="cpu", seed=0).model.state_dict()
    cfg["model"]["hf_sam_pretrain_ckpt_path"] = str(tmp_path / "absent.bin")
    with pytest.warns(UserWarning, match="not found"):
        named = init_detector(cfg, device="cpu", seed=0).model.state_dict()
    assert all(torch.equal(plain[k], named[k]) for k in plain)


# --- a reference-trained mmengine checkpoint --------------------------------

# the port's names -> the reference's: HF modules wrapped one level deep
TO_REFERENCE = (
    (r"^backbone\.", "backbone.vision_encoder."),
    (r"^shared_image_embedding\.", "shared_image_embedding.shared_image_embedding."),
    (r"^neck_feature_aggregator\.", "neck.feature_aggregator."),
    (r"^neck_feature_spliter\.", "neck.feature_spliter."),
    (r"\.mask_decoder\.", ".mask_decoder.mask_decoder."),
)
# mmdet's MultiheadAttention: the query head's decoder attentions
MMDET_MHA = re.compile(r"^(panoptic_head\.transformer_decoder\.layers\.\d+\.(?:self|cross)_attn)"
                       r"\.(q|k|v|out)_proj\.(weight|bias)$")
# what JAX's loader leaves at its init: the BN statistics (it loads
# ``params`` only, not ``batch_stats``), and in the query head the pixel
# decoder's convs (flax names them input_convs_0_conv, which no mmdet name
# maps to) and level encodings (one level_encoding_i vector a level where
# mmdet has one nn.Embedding)
JAX_GAPS = re.compile(r"(\.(running_mean|running_var|num_batches_tracked)$)|"
                      r"(^panoptic_head\.pixel_decoder\.((input|lateral|output)_convs\.\d+\.conv\."
                      r"|level_encoding\.))")


def _reference_state_dict(port_sd, seed=3):
    """Seeded values under the port's names, and the same values under the
    reference's names (qkv of mmdet's attentions packed into
    ``attn.in_proj_*``), as mmengine saves them."""
    rng = np.random.default_rng(seed)
    values = {k: (torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
                  if v.is_floating_point() else v.clone()) for k, v in port_sd.items()}
    ref, packed = {}, {}
    for name, v in values.items():
        m = MMDET_MHA.match(name)
        if m:
            base, proj, leaf = m.groups()
            if proj == "out":
                ref[f"{base}.attn.out_proj.{leaf}"] = v
            else:
                packed.setdefault((base, leaf), {})[proj] = v
            continue
        for pattern, repl in TO_REFERENCE:
            name = re.sub(pattern, repl, name, count=1)
        ref[name] = v
    for (base, leaf), qkv in packed.items():
        ref[f"{base}.attn.in_proj_{leaf}"] = torch.cat([qkv["q"], qkv["k"], qkv["v"]])
    return values, ref


def test_reference_checkpoint_matches_jax(family, tmp_path, monkeypatch):
    """A reference-named mmengine file loads into the port with no missing
    or unused key; through utils/convert.py the result equals JAX's
    load_reference_checkpoint exactly, on every tensor JAX fills (the
    linears fed by a flattened map included: JAX reorders NCHW -> NHWC, the
    port takes them as they are)."""
    from rsprompter_tpu.engine import checkpoint as jax_ck

    mtype = family["type"]
    values, ref_sd = _reference_state_dict(family["port"].state_dict())
    if mtype == "RSPrompterAnchor":
        assert any(k.endswith("mask_decoder.mask_decoder.iou_token.weight") for k in ref_sd)
        assert jax_ck.REFERENCE_FLATTEN_LINEARS["shared_fcs_0"][0] * 49 == \
            values["roi_head.bbox_head.shared_fcs.0.weight"].shape[1]
    else:  # JAX's map also names the query head's point_emb_4, which takes no map
        n_layers = len({k.split(".")[3] for k in values if MMDET_MHA.match(k)})
        assert sum(".attn.in_proj_weight" in k for k in ref_sd) == 2 * n_layers > 0
        monkeypatch.setattr(jax_ck, "REFERENCE_FLATTEN_LINEARS", {})
    path = tmp_path / "epoch_12.pth"
    torch.save({"meta": {"epoch": 12}, "state_dict": ref_sd}, path)

    params, jax_missing = jax_ck.load_reference_checkpoint(
        family["variables"]["params"], jax_load_torch_checkpoint(str(path)), verbose=False)
    params = jax.tree_util.tree_map(np.asarray, params)
    want = jax_to_state_dict({**family["variables"], "params": params})

    port = build_detector(dict(TINY[mtype]))
    port.load_state_dict(family["port"].state_dict(), strict=True)
    missing, unused = ck.load_reference_checkpoint(port, ck.load_torch_checkpoint(str(path)),
                                                   verbose=False)
    assert missing == [] and unused == []
    got = port.state_dict()
    assert got.keys() == want.keys() == values.keys()
    before = family["port"].state_dict()
    gaps = [k for k in got if JAX_GAPS.search(k)]
    for name, t in got.items():
        assert torch.equal(t, values[name]), name  # every tensor is the file's
        if name in gaps:  # JAX left these at their init
            assert torch.equal(want[name], before[name]), name
        else:
            assert torch.equal(t, want[name]), name
    n_bn = sum(k.endswith("running_mean") for k in got)
    pixel_gaps = len(gaps) - 3 * n_bn
    if mtype == "RSPrompterQuery":  # three level_encoding_i in one embedding
        assert n_bn > 0 and pixel_gaps == 11 and len(jax_missing) == 13
    else:
        assert n_bn > 0 and pixel_gaps == 0 and jax_missing == []


def test_reference_checkpoint_strict_and_tool_detection(tmp_path):
    """A key the model lacks or misses raises under strict; the test tool
    tells the port's own state_dict from a reference file by its keys, and
    a port file with a key too many or too few fails as a port file."""
    from rsprompter_tpu_torch.tools.test import load_checkpoint

    mtype = "RSPrompterAnchor"
    port = build_detector(dict(TINY[mtype]))
    values, ref_sd = _reference_state_dict(port.state_dict(), seed=4)
    extra = dict(ref_sd, **{"data_preprocessor.mean": torch.zeros(3)})
    with pytest.raises(KeyError, match="1 unused"):
        ck.load_reference_checkpoint(port, extra, verbose=False)
    short = {k: v for k, v in ref_sd.items() if "fusion_conv" not in k}
    with pytest.raises(KeyError, match="missing"):
        ck.load_reference_checkpoint(port, short, verbose=False)
    assert ck.load_reference_checkpoint(port, extra, strict=False, verbose=False)[1] == [
        "data_preprocessor.mean"]

    torch.save({"state_dict": ref_sd}, tmp_path / "ref.pth")
    torch.save(values, tmp_path / "own.pth")
    for name, kind in (("ref.pth", "reference"), ("own.pth", "port")):
        model = build_detector(dict(TINY[mtype]))
        assert load_checkpoint(model, str(tmp_path / name)) == kind
        assert all(torch.equal(t, values[k]) for k, t in model.state_dict().items())
    torch.save(dict(values, extra=torch.zeros(1)), tmp_path / "own_extra.pth")
    torch.save({k: v for k, v in values.items() if "fusion_conv" not in k},
               tmp_path / "own_short.pth")
    for name, what in (("own_extra.pth", "Unexpected key"), ("own_short.pth", "Missing key")):
        with pytest.raises(RuntimeError, match=what):
            load_checkpoint(build_detector(dict(TINY[mtype])), str(tmp_path / name))
