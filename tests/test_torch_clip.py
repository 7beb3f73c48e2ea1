"""The port's CLIP modules (tise_tpu_torch.backbones.clip_{tokenizer,vit,fast},
core.data.center_crop_resize) against the JAX package's on the CPU.

Weights come from the JAX package's ``random_params`` (full ViT-B/32 width,
shared by the module) or from its small towers' own init, carried across by
``state_dict_from_jax_params``; the merge table is written by the test, and
captions and images are synthesised from numpy seeds.  The RP-COCO and PA
CLIs are in tests/test_torch_clip_cli.py.
"""

import importlib.util
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from tise_tpu.backbones import clip_fast as jfast
from tise_tpu.backbones import clip_tokenizer as jtok
from tise_tpu.backbones import clip_vit as jclip
from tise_tpu.core import data as jdata
from tise_tpu.core import weights as jweights
from tise_tpu.ops import preprocess as jpre
from tise_tpu_torch.backbones import clip_fast as tfast
from tise_tpu_torch.backbones import clip_tokenizer as ttok
from tise_tpu_torch.backbones import clip_vit as tclip
from tise_tpu_torch.core import data as tdata
from tise_tpu_torch.ops import preprocess as tpre

WORDS = ("a the cat dog man woman red blue small big sits on under near left right of table car "
         "tree bird two three and with is are photo picture").split()


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """torch and BLAS on one thread: the suite runs several workers on the same cores."""
    with threadpool_limits(1):
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(before)


def write_merge_table(path, words) -> str:
    """A BPE merge table that builds each word left to right into one token
    (first line a version header, as in CLIP's file)."""
    merges, seen = ["#version: 0.2"], set()
    for word in words:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in seen:
                seen.add(pair)
                merges.append(" ".join(pair))
            parts = [parts[0] + parts[1]] + parts[2:]
    path.write_text("\n".join(merges) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def params():
    """Full-width JAX CLIP params (numpy leaves), made once for the module."""
    return jax.tree_util.tree_map(np.asarray, jclip.random_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def state_dict(params):
    return tclip.state_dict_from_jax_params(params)


def _captions():
    rng = np.random.RandomState(5)
    caps = [" ".join(rng.choice(WORDS, rng.randint(2, 12))) for _ in range(12)]
    return caps + [
        "",
        "A Cat, sitting on 2 TABLES!!! (near the tree)...",
        "the dog&amp;the cat &lt;3 &quot;hello&quot; it's they're we'll",
        "digits 12345 and 3.14, 1st-place; x=y+z? #tag @user",
        "   tabs\tand\nnewlines   between   words  ",
        " ".join(rng.choice(WORDS, 120)),  # over 77 tokens: truncated with EOT in the last slot
        "café naïve über straße",
    ]


def test_tokenizer_equals_jax_id_for_id(tmp_path):
    bpe = write_merge_table(tmp_path / "bpe.txt", WORDS)
    caps = _captions()
    ours, ref = ttok.SimpleTokenizer(bpe), jtok.SimpleTokenizer(bpe)
    got, want = ours.tokenize(caps), ref.tokenize(caps)
    assert got.dtype == want.dtype == np.int32 and got.shape == (len(caps), 77)
    np.testing.assert_array_equal(got, want)
    for cap in caps:
        assert ours.encode(cap) == ref.encode(cap)
        assert ours.decode(ours.encode(cap)) == ref.decode(ref.encode(cap))
    long_row = got[-2]
    assert long_row[0] == ours.sot and long_row[-1] == ours.eot and (long_row != 0).all()
    empty_row = got[caps.index("")]
    assert list(empty_row[:3]) == [ours.sot, ours.eot, 0]
    # EOT is the largest id, so argmax pooling finds it (clip_vit.TextTransformer)
    assert (got.argmax(axis=1) == np.array([list(r).index(ours.eot) for r in got])).all()


def test_tokenizer_re_fallback_agrees_on_ascii(tmp_path, monkeypatch):
    """Without the ``regex`` module the port's word split falls back to an
    ``re`` pattern; on ASCII captions it gives the same ids."""
    monkeypatch.setitem(sys.modules, "regex", None)  # import regex -> ImportError
    spec = importlib.util.spec_from_file_location("clip_tokenizer_re", ttok.__file__)
    fallback = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fallback)
    assert fallback._re.__name__ == "re"
    bpe = write_merge_table(tmp_path / "bpe.txt", WORDS)
    ascii_caps = [c for c in _captions() if c.isascii()]
    np.testing.assert_array_equal(fallback.SimpleTokenizer(bpe).tokenize(ascii_caps),
                                  jtok.SimpleTokenizer(bpe).tokenize(ascii_caps))


@pytest.mark.parametrize("size", [(301, 250), (250, 333), (224, 224), (640, 224)])
def test_center_crop_resize_byte_equal(tmp_path, size):
    """Bicubic shorter-side resize and centre crop, byte for byte as the JAX
    package's, on portrait and landscape PNGs (odd crop offsets at the first
    two sizes: 270 - 224 and 298 - 224 leave 23 and 37)."""
    w, h = size
    arr = np.random.RandomState(w + h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    path = str(tmp_path / "im.png")
    Image.fromarray(arr).save(path)
    got = tdata.center_crop_resize(path, 224)
    assert got.shape == (224, 224, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jdata.center_crop_resize(path, 224))


def test_center_crop_loader_matches_jax(tmp_path):
    for i, size in enumerate([(301, 250), (250, 333), (320, 256)]):
        arr = np.random.RandomState(i).randint(0, 256, (size[1], size[0], 3)).astype(np.uint8)
        Image.fromarray(arr).save(str(tmp_path / f"{i}.png"))
    files = tdata.list_images(str(tmp_path))
    ours = list(tdata.ImageFolderLoader(files, 2, 224, resample=tdata.BICUBIC, center_crop=True))
    ref = list(jdata.ImageFolderLoader(files, 2, 224, resample=jdata.BICUBIC, center_crop=True))
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.images, r.images)
        np.testing.assert_array_equal(o.mask, r.mask)


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def test_small_towers_match_jax():
    """Width 64, 2 layers, 2 heads, 64 px images with 16 px patches: the
    image and text towers within rtol 1e-4, atol 1e-4 of the output's scale
    (flax's one-pass LayerNorm variance against torch's two-pass)."""
    rng = np.random.RandomState(0)
    kw = dict(width=64, layers=2, heads=2, output_dim=32)
    jv = jclip.VisionTransformer(patch_size=16, **kw)
    jt = jclip.TextTransformer(**kw)
    imgs = rng.randn(3, 64, 64, 3).astype(np.float32)
    toks = np.zeros((3, 77), np.int32)
    toks[:, 0] = 49406
    toks[:, 1:9] = rng.randint(1, 400, (3, 8))
    toks[0, 9], toks[1, 4], toks[2, 76] = 49407, 49407, 49407
    toks[1, 5:] = 0
    pv, pt = jax.jit(jv.init)(jax.random.PRNGKey(1), imgs), jax.jit(jt.init)(jax.random.PRNGKey(2), toks)
    tree = jax.tree_util.tree_map(np.asarray, {"params": {"visual": pv["params"], "text": pt["params"],
                                                          "logit_scale": np.float32(0.0)}})
    sd = {k: torch.from_numpy(v) for k, v in tclip.state_dict_from_jax_params(tree).items()}
    tv = tclip.VisionTransformer(patch_size=16, input_resolution=64, **kw)
    tv.load_state_dict({k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")})
    tt = tclip.TextTransformer(**kw)
    tt.load_state_dict({k: v for k, v in sd.items() if not k.startswith("visual.") and k != "logit_scale"})
    with torch.no_grad():
        _close(tv(torch.from_numpy(imgs)).numpy(), np.asarray(jax.jit(jv.apply)(pv, imgs)), 1e-4)
        _close(tt(torch.from_numpy(toks).long()).numpy(), np.asarray(jax.jit(jt.apply)(pt, toks)), 1e-4)


def test_full_width_clip_matches_jax(params, state_dict):
    """ViT-B/32 at full width on 2 images and 3 captions: both towers and
    the logits within 1e-4 of their scale."""
    rng = np.random.RandomState(1)
    imgs = (rng.randn(2, 224, 224, 3) * 0.5).astype(np.float32)
    toks = np.zeros((3, 77), np.int32)
    toks[:, 0] = 49406
    toks[:, 1:6] = rng.randint(1, 400, (3, 5))
    toks[:, 6] = 49407
    jm = jclip.CLIP()
    j_img, j_txt, j_logits = (np.asarray(a) for a in jax.jit(lambda p, i, t: (
        jm.apply(p, i, method=jm.encode_image), jm.apply(p, t, method=jm.encode_text), jm.apply(p, i, t)[0]))(
            params, imgs, toks))
    model = tclip.CLIP.from_state_dict(state_dict, device="cpu")
    with torch.no_grad():
        t_img = model.encode_image(torch.from_numpy(imgs)).numpy()
        t_txt = model.encode_text(torch.from_numpy(toks).long()).numpy()
        t_logits, t_per_text = model(torch.from_numpy(imgs), torch.from_numpy(toks).long())
    _close(t_img, j_img, 1e-4)
    _close(t_txt, j_txt, 1e-4)
    _close(t_logits.numpy(), j_logits, 1e-4)
    np.testing.assert_array_equal(t_per_text.numpy(), t_logits.numpy().T)


def test_fast_visual_matches_jax_fast(params, state_dict):
    """The bf16 image tower against the JAX FastCLIPVisual within 5e-2 of
    the output's scale (the JAX suite's fast-against-f32 tolerance), and
    both against the f32 module."""
    u8 = np.random.RandomState(2).randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    jf = jfast.FastCLIPVisual(params, dtype=jnp.bfloat16)
    ref_fast = np.asarray(jax.jit(lambda v: jf(jpre.normalize(v, "clip", jnp.bfloat16)))(u8).astype(jnp.float32))
    fast = tfast.FastCLIPVisual(state_dict, torch.bfloat16, device="cpu")
    model = tclip.CLIP.from_state_dict(state_dict, device="cpu")
    x = torch.from_numpy(u8)
    with torch.no_grad():
        got = fast(tpre.normalize(x, "clip", torch.bfloat16))
        f32 = model.encode_image(tpre.normalize(x, "clip")).numpy()
    assert got.dtype == torch.bfloat16 and got.shape == (2, 512)
    _close(got.float().numpy(), ref_fast, 5e-2)
    _close(got.float().numpy(), f32, 5e-2)


class _Scripted(torch.nn.Module):
    """A scriptable module holding three CLIP weights under their OpenAI
    names and one of the checkpoint's non-weight buffers."""

    def __init__(self, sd):
        super().__init__()
        self.visual = torch.nn.Module()
        self.visual.proj = torch.nn.Parameter(sd["visual.proj"])
        self.logit_scale = torch.nn.Parameter(sd["logit_scale"])
        self.ln_final = torch.nn.Module()
        self.ln_final.bias = torch.nn.Parameter(sd["ln_final.bias"])
        self.register_buffer("input_resolution", torch.tensor(224))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.logit_scale


def test_jax_npz_and_pt_weights_load(tmp_path, params, state_dict):
    """A ``.npz`` written by the JAX package's save_pytree_npz loads into the
    port; a plain OpenAI-layout ``.pt`` (with the checkpoint's three
    non-weight entries), a TorchScript archive and an OpenAI-layout ``.npz``
    load as they are; the OpenAI layout goes into the JAX converter and back
    unchanged."""
    npz = str(tmp_path / "clip.npz")
    jweights.save_pytree_npz(npz, params)
    got = tclip.load_params(npz)
    assert set(got) == set(state_dict)
    for k, v in state_dict.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = tclip.state_dict_from_jax_params(jclip.params_from_openai_state_dict(state_dict))
    for k, v in state_dict.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    small = {k: v for k, v in state_dict.items() if k in ("visual.proj", "logit_scale", "ln_final.bias")}
    pt = str(tmp_path / "clip.pt")
    torch.save({**{k: torch.from_numpy(v) for k, v in small.items()},
                "input_resolution": torch.tensor(224), "context_length": torch.tensor(77),
                "vocab_size": torch.tensor(49408)}, pt)
    flat = str(tmp_path / "flat.npz")  # an OpenAI-layout state dict saved with np.savez
    np.savez(flat, **small)
    scripted = str(tmp_path / "scripted.pt")  # the TorchScript archive form of OpenAI's released files
    torch.jit.script(_Scripted({k: torch.from_numpy(v) for k, v in small.items()})).save(scripted)
    for loaded in (tclip.load_params(pt), tclip.load_params(flat), tclip.load_params(scripted)):
        assert set(loaded) == set(small)
        for k, v in small.items():
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_random_state_dict_has_the_openai_layout(state_dict):
    """random_state_dict has the keys and shapes of the JAX package's
    params carried across (the OpenAI layout at ViT-B/32's widths), the
    init's logit scale, and the same values for the same seed."""
    sd = tclip.random_state_dict(seed=3)
    assert {k: v.shape for k, v in sd.items()} == {k: v.shape for k, v in state_dict.items()}
    assert all(v.dtype == np.float32 for v in sd.values())
    assert float(sd["logit_scale"]) == pytest.approx(np.log(1 / 0.07))
    assert float(sd["visual.conv1.weight"].std()) == pytest.approx(768 ** -0.5, rel=0.01)
    np.testing.assert_array_equal(tclip.random_state_dict(seed=3)["visual.proj"], sd["visual.proj"])
