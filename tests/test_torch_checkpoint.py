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
"""

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
    port = build_detector(dict(TINY["RSPrompterAnchor"]))
    with pytest.raises(NotImplementedError):
        ck.load_sam_pretrained(port, {}, "SAMSegMaskRCNN")
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
