"""The port's text encoders and tokenizers against the JAX package (and
against ``transformers``/``tokenizers`` where JAX calls them).

- ``load_t5_hf`` on an HF ``T5EncoderModel`` state: every leaf equal to
  JAX's; ``t5_encode`` with and without an attention mask: f32 within
  1e-5, bf16 within a relative L2 of 1e-2 (bf16 matmuls round differently
  in the two packages on the CPU).
- ``load_clip_hf``, ``load_clip_hf_text_only`` and ``load_clip_openclip``
  (through ``load_torch_state`` on the rehearsal HPS ``.pt``): every leaf
  equal; ``clip_text_features`` (projected and not) and
  ``clip_image_features``: f32 within 1e-5, bf16 within 1e-2 relative L2.
- the ``tokenizer.json`` reader id for id against ``AutoTokenizer`` on the
  rehearsal ``WordLevel`` file and on ``Unigram`` files built here with
  ``tokenizers`` (NFKC, Metaspace, a ``</s>`` template, a synthetic
  ``Precompiled`` char map): long, empty and non-ASCII prompts; the
  ``Precompiled`` normalizer against ``tokenizers``' and hand-computed
  strings; unknown component types raise.
- the copied ``CLIPTokenizer`` id for id against JAX's.
"""

import base64
import copy
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixgrpo_tpu.models.flux.load import load_safetensors_dir as j_load_dir
from mixgrpo_tpu.models.text import clip as JC
from mixgrpo_tpu.models.text import clip_load as JCL
from mixgrpo_tpu.models.text import t5 as JT5
from mixgrpo_tpu.rewards.tokenizer import CLIPTokenizer as JCLIPTokenizer
from mixgrpo_tpu_torch.models.flux.load import load_safetensors_dir
from mixgrpo_tpu_torch.models.text import clip as C
from mixgrpo_tpu_torch.models.text import clip_load as CL
from mixgrpo_tpu_torch.models.text import t5 as T5
from mixgrpo_tpu_torch.models.text import tokenizer_json as TJ
from mixgrpo_tpu_torch.rewards import CLIPTokenizer
from tests.test_torch_load import assert_trees_equal, write_rehearsal_tree


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_rehearsal_tree(tmp_path_factory.mktemp("ckpts"))


# ---------------------------------------------------------------------------
# T5
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def t5_state():
    from transformers import T5Config as HFT5Config
    from transformers import T5EncoderModel

    torch.manual_seed(0)
    hf = T5EncoderModel(HFT5Config(
        vocab_size=128, d_model=32, d_kv=16, d_ff=64, num_layers=2, num_heads=2,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        feed_forward_proj="gated-gelu", dropout_rate=0.0, use_cache=False)).eval()
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


@pytest.mark.parametrize("masked", [False, True])
def test_t5_matches_jax(t5_state, masked):
    jcfg, cfg = JT5.T5Config.tiny(), T5.T5Config.tiny()
    jp = JT5.load_t5_hf(t5_state, jcfg)
    tp = T5.load_t5_hf(t5_state, cfg, device="cpu")
    assert_trees_equal(tp, jp)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, size=(3, 40)).astype(np.int32)  # past the 16-token max distance
    mask = None
    if masked:
        mask = np.ones((3, 40), bool)
        mask[0, 25:] = False
        mask[2, 3:] = False
    for jdt, dt, check in ((jnp.float32, torch.float32,
                            lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)),
                           (jnp.bfloat16, torch.bfloat16,
                            lambda g, w: (rel_l2(g, w) < 1e-2) or pytest.fail(rel_l2(g, w)))):
        want = np.asarray(JT5.t5_encode(jp, jcfg, jnp.asarray(ids),
                                        None if mask is None else jnp.asarray(mask), dtype=jdt))
        got = T5.t5_encode(tp, cfg, torch.from_numpy(ids),
                           None if mask is None else torch.from_numpy(mask), dtype=dt)
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 40, 32)
        check(got.numpy(), want)


def test_t5_relative_buckets_match_jax():
    rel = np.arange(-300, 301)
    for nb, md in ((32, 128), (8, 16)):
        want = np.asarray(JT5._relative_buckets(jnp.asarray(rel), nb, md))
        got = T5._relative_buckets(torch.from_numpy(rel), nb, md)
        np.testing.assert_array_equal(got.numpy(), want)


def test_t5_init_shapes():
    cfg = T5.T5Config.tiny()
    p = T5.init_t5(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    jp = JT5.init_t5(jax.random.key(0), JT5.T5Config.tiny())
    assert {k: tuple(v.shape) for k, v in p["blocks"].items()} == \
        {k: tuple(v.shape) for k, v in jp["blocks"].items()}
    out = T5.t5_encode(p, cfg, torch.full((1, 6), 3), dtype=torch.float32)
    assert out.shape == (1, 6, cfg.d_model) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def _clip_cfgs():
    kw = dict(embed_dim=16, quick_gelu=True)
    v = dict(width=32, layers=2, heads=2, patch=8, image_size=32)
    t = dict(width=32, layers=2, heads=2, vocab=64, context=16)
    return (JC.CLIPConfig(vision=JC.CLIPTowerConfig(**v), text=JC.CLIPTowerConfig(**t), **kw),
            C.CLIPConfig(vision=C.CLIPTowerConfig(**v), text=C.CLIPTowerConfig(**t), **kw))


@pytest.fixture(scope="module")
def clip_state():
    from transformers import CLIPConfig as HFCLIPConfig
    from transformers import CLIPModel

    torch.manual_seed(1)
    act = "quick_gelu"
    hf = CLIPModel(HFCLIPConfig(
        text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=16, hidden_act=act),
        vision_config=dict(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=8,
                           hidden_act=act),
        projection_dim=16)).eval()
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


def _clip_inputs():
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 60, size=(3, 16)).astype(np.int32)
    ids[0, 5], ids[1, 15], ids[2, 0] = 63, 63, 63  # the end-of-text (max) id
    ids[0, 6:] = 0
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return ids, images


def _check_features(jp, tp, jcfg, cfg, text_only=False):
    ids, images = _clip_inputs()
    for jdt, dt, tight in ((jnp.float32, torch.float32, True), (jnp.bfloat16, torch.bfloat16,
                                                              False)):
        pairs = []
        for kw in (dict(project=True), dict(normalize=False, project=False)):
            pairs.append((C.clip_text_features(tp, cfg, torch.from_numpy(ids), dtype=dt, **kw),
                          JC.clip_text_features(jp, jcfg, jnp.asarray(ids), dtype=jdt, **kw)))
        if not text_only:
            pairs.append((C.clip_image_features(tp, cfg, torch.from_numpy(images), dtype=dt),
                          JC.clip_image_features(jp, jcfg, jnp.asarray(images), dtype=jdt)))
        for got, want in pairs:
            assert got.dtype == torch.float32
            if tight:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
            else:
                assert rel_l2(got.numpy(), want) < 1e-2


def test_clip_hf_matches_jax(clip_state):
    jcfg, cfg = _clip_cfgs()
    jp = JCL.load_clip_hf(clip_state, jcfg)
    tp = CL.load_clip_hf(clip_state, cfg, device="cpu")
    assert_trees_equal(tp, jp)
    _check_features(jp, tp, jcfg, cfg)


def test_clip_text_only_matches_jax(clip_state):
    """FLUX's ``text_encoder`` layout: text tower names only, no projection
    (identity)."""
    jcfg, cfg = _clip_cfgs()
    st = {k: v for k, v in clip_state.items() if k.startswith("text_model.")}
    jp = JCL.load_clip_hf_text_only(st, jcfg)
    tp = CL.load_clip_hf_text_only(st, cfg, device="cpu")
    assert_trees_equal(tp, jp)
    _check_features(jp, tp, jcfg, cfg, text_only=True)


def test_clip_openclip_matches_jax(tree):
    """The rehearsal HPS checkpoint (OpenCLIP names nested under
    ``state_dict`` in a ``.pt``) with its sibling ``open_clip_config.json``."""
    path = os.path.join(os.path.dirname(tree), "HPS_v2.1_compressed.pt")
    jcfg = JCL.clip_config_from_checkpoint(path)
    cfg = CL.clip_config_from_checkpoint(path)
    assert jcfg.__repr__().replace("mixgrpo_tpu.", "") == cfg.__repr__().replace(
        "mixgrpo_tpu_torch.", "")
    jp = JCL.load_clip_openclip(JCL.load_torch_state(path), jcfg)
    tp = CL.load_clip_openclip(CL.load_torch_state(path), cfg, device="cpu")
    assert_trees_equal(tp, jp)
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        C.clip_image_features(tp, cfg, torch.from_numpy(images)).numpy(),
        np.asarray(JC.clip_image_features(jp, jcfg, jnp.asarray(images))), rtol=0, atol=1e-5)


def test_clip_configs_and_safetensors_state(tree):
    """Config introspection of both flavours, and ``load_torch_state`` of a
    ``.safetensors`` file (the rehearsal CLIP-L text encoder) read lazily."""
    hf = {"projection_dim": 16,
          "vision_config": {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                            "patch_size": 8, "image_size": 32, "hidden_act": "quick_gelu"},
          "text_config": {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                          "vocab_size": 64, "max_position_embeddings": 16}}
    assert CL.clip_config_from_json(hf) == _clip_cfgs()[1]
    assert CL.clip_config_from_checkpoint("/nonexistent/x.pt", default=_clip_cfgs()[1]) \
        == _clip_cfgs()[1]
    path = os.path.join(tree, "text_encoder", "model.safetensors")
    st = CL.load_torch_state(path)
    want = JCL.load_torch_state(path)
    assert sorted(st) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(st[k].float().numpy(), want[k])


def test_flux_text_encoder_dir_matches_jax(tree):
    """The rehearsal ``text_encoder/`` and ``text_encoder_2/`` read lazily by
    the port equal JAX's loads of the same files."""
    from mixgrpo_tpu import presets as JP
    from mixgrpo_tpu_torch import presets as P

    jfam, fam = JP.flux_family("tiny"), P.flux_family("tiny")
    d5, dc = os.path.join(tree, "text_encoder_2"), os.path.join(tree, "text_encoder")
    assert_trees_equal(T5.load_t5_hf(load_safetensors_dir(d5), fam["t5"], device="cpu"),
                       JT5.load_t5_hf(j_load_dir(d5), jfam["t5"]))
    assert_trees_equal(
        CL.load_clip_hf_text_only(load_safetensors_dir(dc), fam["clip"], device="cpu"),
        JCL.load_clip_hf_text_only(j_load_dir(dc), jfam["clip"]))


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------


PROMPTS = [
    "a photo of a corgi wearing sunglasses on the beach",
    "",
    "   oil painting of the city skyline at night , neon reflections  ",
    "Macro shot of dew-covered spider web at dawn!!",
    "Ｆｕｌｌｗｉｄｔｈ ﬁsh café crème brûlée 東京タワー 夜景 😀👍🏽 naïve",
    " ".join(["a futuristic cat and a dog"] * 150),  # > 512 tokens
    "unknown words zzz qqq and a </s> and <pad> inside",
]


def _hf(path):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)


def _assert_same_ids(path, max_lengths=(512, 16)):
    hf, mine = _hf(path), TJ.TokenizerJSON(path)
    for ml in max_lengths:
        want = hf(PROMPTS, padding="max_length", truncation=True, max_length=ml,
                  return_tensors="np")["input_ids"]
        got = mine(PROMPTS, padding="max_length", truncation=True, max_length=ml,
                   return_tensors="np")["input_ids"]
        assert got.shape == want.shape == (len(PROMPTS), ml)
        for p, g, w in zip(PROMPTS, got, want):
            np.testing.assert_array_equal(g, w, err_msg=p[:60])
    return want


def test_wordlevel_rehearsal_matches_autotokenizer(tree):
    ids = _assert_same_ids(os.path.join(tree, "tokenizer_2"))
    assert (ids[1] == 1).all()  # the rehearsal's pad id is 1, and no template


def build_charsmap(mapping):
    """A sentencepiece precompiled char map for ``mapping``: a darts-clone
    double-array trie over the UTF-8 keys (each unit: label in bits 0-7,
    has-leaf bit 8, offset from bit 10; a leaf unit holds its value with bit
    31 set) after a little-endian u32 of its byte size, then the
    NUL-terminated replacement strings."""
    blob, trie = b"", {}
    for k, v in mapping.items():
        node = trie
        for c in k.encode():
            node = node.setdefault(c, {})
        node[None] = len(blob)
        blob += v.encode() + b"\0"
    units, used = [0], {0}

    def place(node, pos):
        labels = sorted(0 if c is None else c for c in node)
        b = 1
        while any((b ^ c) in used for c in labels):
            b += 1
        used.update(b ^ c for c in labels)
        units.extend([0] * (max(b ^ c for c in labels) + 1 - len(units)))
        units[pos] |= (pos ^ b) << 10
        for c, child in node.items():
            if c is None:
                units[b] = child | (1 << 31)
                if pos:
                    units[pos] |= 1 << 8
                continue
            units[b ^ c] |= c
            if None in child:
                units[b ^ c] |= 1 << 8
            place(child, b ^ c)

    place(trie, 0)
    arr = np.asarray(units, "<u4").tobytes()
    return base64.b64encode(struct.pack("<I", len(arr)) + arr + blob).decode()


CHARSMAP = {"Ａ": "A", "ﬁ": "fi", "\t": " ", "é": "é", " ": " ", "ｶ": "カ",
            "😀": "", "x": "y", "　": " "}


def _unigram_dir(root, name, normalizer, pre_tokenizer, pieces=400, seed=0):
    """A T5-like ``Unigram`` tokenizer written by ``tokenizers``: <pad>=0,
    </s>=1, <unk>=2, random scored pieces over the prompts' alphabet and
    ``TemplateProcessing`` appending ``</s>``; its normalizer and
    pre-tokenizer JSON replaced by the given ones."""
    from tokenizers import Tokenizer, processors
    from tokenizers.models import Unigram

    rng = np.random.default_rng(seed)
    alphabet = sorted(set("".join(PROMPTS).lower()) - {" "})
    vocab = set()
    while len(vocab) < pieces:
        w = "".join(rng.choice(alphabet, int(rng.integers(1, 6))))
        vocab.add(("▁" + w) if rng.random() < 0.4 else w)
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.0)] + \
        [(p, float(-rng.uniform(3, 12))) for p in sorted(vocab)]
    tok = Tokenizer(Unigram(vocab, unk_id=2, byte_fallback=False))
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    d = os.path.join(str(root), name)
    os.makedirs(d)
    spec = json.loads(tok.to_str())
    spec["normalizer"], spec["pre_tokenizer"] = normalizer, pre_tokenizer
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 512,
                   "pad_token": "<pad>", "eos_token": "</s>", "unk_token": "<unk>"}, f)
    return d


META = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always", "split": True}
UNIGRAMS = {
    "nfkc_metaspace": (
        {"type": "Sequence", "normalizers": [
            {"type": "NFKC"}, {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        META),
    "lower_strip_whitespacesplit": (
        {"type": "Sequence", "normalizers": [{"type": "Lowercase"}, {"type": "Strip",
                                                                     "strip_left": True,
                                                                     "strip_right": True}]},
        {"type": "Sequence", "pretokenizers": [{"type": "WhitespaceSplit"}, META]}),
    "precompiled_legacy_metaspace": (
        {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": build_charsmap(CHARSMAP)},
            {"type": "Replace", "pattern": {"String": "  "}, "content": " "}]},
        {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}),
    "nfd_whitespace_nosplit": (
        {"type": "NFD"},
        {"type": "Sequence", "pretokenizers": [
            {"type": "Whitespace"},
            {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "never",
             "split": False}]}),
}


@pytest.mark.parametrize("name", sorted(UNIGRAMS))
def test_unigram_matches_autotokenizer(tmp_path, name):
    """T5's truncate-then-append order: the </s> of a long prompt is its
    max_length-th id; the pad id is 0."""
    d = _unigram_dir(tmp_path, name, *UNIGRAMS[name])
    ids = _assert_same_ids(d)
    assert ids[5, -1] == 1 and (ids[1, 1:] == 0).all()


def test_precompiled_matches_tokenizers():
    """The char map reader against ``tokenizers``' own ``Precompiled``, and
    hand-computed strings: a grapheme shorter than 6 bytes is replaced whole
    by its shortest mapped prefix ("x" + a combining acute -> "y")."""
    from tokenizers import normalizers

    cm = build_charsmap(CHARSMAP)
    ref = normalizers.Precompiled(base64.b64decode(cm))
    mine = TJ._Precompiled(cm)
    cases = {"Ａbc ﬁ\tx": "Abc fi y", "café x́ a": "café y a", "ｶ😀 end": "カ end",
             "plain": "plain", "　é́": " é", "👍🏽 🇫🇷 \r\n": "👍🏽 🇫🇷 \r\n"}
    for text, want in cases.items():
        assert mine(text) == want, text
        assert ref.normalize_str(text) == want, text


BAD = [
    ("normalizer", {"type": "Nmt"}),  # not taken (BertNormalizer is: BERT's WordPiece)
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False}),
    ("pre_tokenizer", dict(META, prepend_scheme="first")),
    # BPE is taken (the Llama-3 tokenizer), its byte fallback is not
    ("model", {"type": "BPE", "vocab": {}, "merges": [], "byte_fallback": True}),
    ("post_processor", {"type": "RobertaProcessing"}),
]


@pytest.mark.parametrize("key,spec", BAD, ids=[f"{k}-{s['type']}" for k, s in BAD])
def test_unknown_components_raise(tmp_path, key, spec):
    d = _unigram_dir(tmp_path, "t", *UNIGRAMS["nfkc_metaspace"], pieces=20)
    with open(os.path.join(d, "tokenizer.json")) as f:
        full = json.load(f)
    full = copy.deepcopy(full)
    full[key] = spec
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(full, f)
    with pytest.raises(ValueError, match=spec["type"] if key != "pre_tokenizer" or
                       "prepend_scheme" not in spec else "first"):
        TJ.TokenizerJSON(d)


def test_clip_tokenizer_matches_jax(tree):
    merges = os.path.join(tree, "tokenizer", "merges.txt")
    got, want = CLIPTokenizer(merges)(PROMPTS), JCLIPTokenizer(merges)(PROMPTS)
    assert got.dtype == want.dtype and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)
