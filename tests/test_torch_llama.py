"""The port's Llama-3 text tower, HunyuanVideo's LLM text encoder and the
Llama-3 byte-level BPE reader against the JAX package and ``transformers``.

- ``llama_hidden_states`` at ``LlamaConfig.tiny()`` (GQA 4 heads over 2 kv
  heads) in f32, right padding, ``hidden_state_skip_layer`` 0 and 2: against
  JAX with its weights (atol 1e-5), and against ``transformers.LlamaModel``
  through ``load_llama_hf`` on its state dict (``last_hidden_state`` and
  ``hidden_states[-3]`` on the unpadded positions, atol 2e-4, as
  tests/test_llama.py holds JAX).
- ``LLMTextEncoder``: the template, ``max_length + crop_start`` and the crop
  against JAX's (atol 1e-5), and ``json_tokenize_fn`` +
  ``from_checkpoint`` on a safetensors tower.
- the tokenizer: a byte-level BPE ``tokenizer.json`` trained here with
  ``tokenizers`` (Llama-3's Split pattern, ByteLevel, ``ignore_merges``,
  the special tokens, the ``<|begin_of_text|>`` template) read by the port,
  id for id and mask for mask against JAX's ``hf_tokenize_fn``
  (``transformers.AutoTokenizer``) on the official templated prompts and on
  Unicode text drawn by ``hypothesis`` (letters, digits, ``²``, ``½``, CJK,
  emoji, CR LF, runs of spaces); the same for ``chip_smoke``'s synthetic
  tokenizer writer; components the reader does not take raise naming them.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke as CS
from mixgrpo_tpu.models.hunyuan import text_encoder as JTE
from mixgrpo_tpu.models.text import llama as JL
from mixgrpo_tpu_torch.convert import from_jax_params
from mixgrpo_tpu_torch.models.hunyuan import text_encoder as TE
from mixgrpo_tpu_torch.models.text import llama as L
from mixgrpo_tpu_torch.models.text import tokenizer_json as TJ
from mixgrpo_tpu_torch.utils.safetensors_io import save_file

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

CFG, JCFG = L.LlamaConfig.tiny(), JL.LlamaConfig.tiny()
IDS = np.array([[5, 17, 99, 3, 42, 0, 0, 0], [8, 1, 2, 3, 4, 5, 6, 7]], np.int64)
MASK = np.array([[1, 1, 1, 1, 1, 0, 0, 0], [1] * 8], np.int64)


@pytest.fixture(scope="module")
def jax_weights():
    tree = jax.tree.map(np.asarray, JL.init_llama(jax.random.key(0), JCFG))
    return jax.tree.map(jnp.asarray, tree), from_jax_params(tree, "cpu")


@pytest.mark.parametrize("skip", [0, 2])
def test_hidden_states_match_jax(jax_weights, skip):
    jp, tp = jax_weights
    want = np.asarray(JL.llama_hidden_states(jp, JCFG, jnp.asarray(IDS), jnp.asarray(MASK),
                                             hidden_state_skip_layer=skip, dtype=jnp.float32))
    got = L.llama_hidden_states(tp, CFG, torch.from_numpy(IDS), torch.from_numpy(MASK),
                                hidden_state_skip_layer=skip, dtype=torch.float32).numpy()
    assert got.shape == (2, 8, CFG.d_model) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="skip"):
        L.llama_hidden_states(tp, CFG, torch.from_numpy(IDS), hidden_state_skip_layer=5)


def test_hidden_states_match_transformers(tmp_path):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0, rms_norm_eps=1e-5,
        attention_bias=False, mlp_bias=False, tie_word_embeddings=False,
        max_position_embeddings=64)
    torch.manual_seed(0)
    hf = transformers.LlamaModel(hf_cfg).eval()
    with torch.no_grad():
        out = hf(input_ids=torch.from_numpy(IDS), attention_mask=torch.from_numpy(MASK),
                 output_hidden_states=True)
    # HF names as written beside the released tower ("model." prefix), read lazily
    path = str(tmp_path / "llm")
    save_file({f"model.{k}": v for k, v in hf.state_dict().items()},
              os.path.join(path, "model.safetensors"))
    from mixgrpo_tpu_torch.utils.safetensors_io import SafetensorsDir

    state = SafetensorsDir(path)
    assert L.llama_layers_in(state) == 4
    params = L.load_llama_hf(state, CFG, device="cpu", dtype=torch.float32)
    valid = MASK.astype(bool)
    for skip, want in ((0, out.last_hidden_state), (2, out.hidden_states[-3])):
        got = L.llama_hidden_states(params, CFG, torch.from_numpy(IDS), torch.from_numpy(MASK),
                                    hidden_state_skip_layer=skip, dtype=torch.float32)
        np.testing.assert_allclose(got.numpy()[valid], want.numpy()[valid], rtol=2e-4, atol=2e-4)


def _char_tokenize(texts, max_length):
    """A fixed stand-in tokenizer: bytes mod the vocab, right padding."""
    ids = np.zeros((len(texts), max_length), np.int64)
    mask = np.zeros((len(texts), max_length), np.int64)
    for i, t in enumerate(texts):
        bs = [1 + (b % 120) for b in t.encode()][:max_length]
        ids[i, :len(bs)], mask[i, :len(bs)] = bs, 1
    return ids, mask


def test_text_encoder_templates_and_crop_match_jax(jax_weights):
    jp, tp = jax_weights
    tpl = {"template": "instruction: {}", "crop_start": 5}
    kw = dict(tokenize_fn=_char_tokenize, max_length=16, hidden_state_skip_layer=2,
              prompt_template=tpl, prompt_template_video={"template": "video, {}!",
                                                           "crop_start": 3})
    j = JTE.LLMTextEncoder(params=jp, cfg=JCFG, dtype=jnp.float32, **kw)
    p = TE.LLMTextEncoder(params=tp, cfg=CFG, dtype=torch.float32, **kw)
    for data_type, crop in (("image", 5), ("video", 3)):
        ids, mask = p.text2tokens(["a cat", "a dog on the beach"], data_type)
        jids, jmask = j.text2tokens(["a cat", "a dog on the beach"], data_type)
        np.testing.assert_array_equal(ids, jids)
        assert ids.shape == (2, 16 + crop)
        hid, m = p(["a cat", "a dog on the beach"], data_type)
        jhid, jm = j(["a cat", "a dog on the beach"], data_type)
        assert hid.shape == (2, 16, CFG.d_model)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_allclose(hid.numpy(), np.asarray(jhid), rtol=0, atol=1e-5)
    p.prompt_template = None
    assert p("hello", "image")[0].shape == (1, 16, CFG.d_model)
    with pytest.raises(ValueError, match="data type"):
        p("hello", "audio")
    assert TE.HUNYUAN_PROMPT_TEMPLATES == JTE.HUNYUAN_PROMPT_TEMPLATES


# ---------------------------------------------------------------------------
# the Llama-3 byte-level BPE reader
# ---------------------------------------------------------------------------

SPECIAL = CS.LLAMA3_SPECIAL
CORPUS = [t["template"].format(p) for t in JTE.HUNYUAN_PROMPT_TEMPLATES.values()
          for p in CS.HV_PROMPTS] + [
    "The quick brown fox's 12345 jumps ½ ² over the lazy dog\r\n\n  spaces\t東京 😀 café."] * 3


def _config(d):
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<|end_of_text|>",
                   "bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"}, f)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tokenizer.json trained by ``tokenizers`` in Llama-3's structure."""
    from tokenizers import (AddedToken, Regex, Tokenizer, models, pre_tokenizers, processors,
                            trainers)

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(TJ.LLAMA3_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False)])
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=700, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), special_tokens=[]))
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in SPECIAL])
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                      special_tokens=[("<|begin_of_text|>", bos)])])
    d = str(tmp_path_factory.mktemp("llama3_tok"))
    tok.save(os.path.join(d, "tokenizer.json"))
    _config(d)
    return d, TE.json_tokenize_fn(d), JTE.hf_tokenize_fn(d)


def _same(mine, theirs, texts, max_length):
    ids, mask = mine(texts, max_length)
    jids, jmask = theirs(texts, max_length)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    return ids, mask


def test_bpe_reader_matches_hf_on_templates(trained):
    d, mine, theirs = trained
    prompts = list(CS.HV_PROMPTS) + ["", "a cat", "Don't STOP—we'll see 1999's ½²"]
    for tpl in JTE.HUNYUAN_PROMPT_TEMPLATES.values():
        texts = [tpl["template"].format(p) for p in prompts]
        ids, mask = _same(mine, theirs, texts, 256 + tpl["crop_start"])
        assert len(set(ids[:, 0])) == 1  # <|begin_of_text|> first
        assert mask.sum(1).min() > 30 and (mask[:, -1] == 0).all()
    # truncation: the template cut at max_length, bos kept
    ids, mask = _same(mine, theirs, [JTE.HUNYUAN_PROMPT_TEMPLATE_ENCODE_VIDEO.format("x")], 20)
    assert mask.all()


@settings(max_examples=60, deadline=None)
@given(st.text(alphabet=st.one_of(
    st.sampled_from(list("aZé'sStTlLdDmMvVrReE 0123456789²½³¼東京の夜😀🦊\r\n\t.,!?-_\"")),
    st.characters(exclude_categories=("Cs", "Cn"))), max_size=40))
def test_bpe_reader_matches_hf_on_unicode(trained, text):
    _, mine, theirs = trained
    _same(mine, theirs, [text, "  " + text + "\r\n", text + "   x"], 96)


def test_smoke_tokenizer_writer_matches_hf(tmp_path):
    d = str(tmp_path / "tok")
    CS.write_llama3_tokenizer(d, n_merges=300)
    mine, theirs = TE.json_tokenize_fn(d), JTE.hf_tokenize_fn(d)
    texts = [t["template"].format(p) for t in JTE.HUNYUAN_PROMPT_TEMPLATES.values()
             for p in CS.HV_PROMPTS + ("an unseen prompt, 42 ½",)]
    ids, _ = _same(mine, theirs, texts, 351)
    assert (ids[:, 0] == SPECIAL["<|begin_of_text|>"]).all()
    assert SPECIAL["<|start_header_id|>"] in ids and SPECIAL["<|eot_id|>"] in ids


def test_added_tokens_numbered_as_tokenizers_does(trained, tmp_path):
    """Added tokens whose file ids skip past the vocabulary are numbered
    from its size, as ``tokenizers`` numbers them (the template keeps the
    file's bos id, as ``tokenizers`` does)."""
    d, _, _ = trained
    with open(os.path.join(d, "tokenizer.json")) as f:
        spec = json.load(f)
    for k, t in enumerate(spec["added_tokens"]):
        t["id"] = 128000 + 3 * k
    e = str(tmp_path / "gapped")
    os.makedirs(e)
    with open(os.path.join(e, "tokenizer.json"), "w") as f:
        json.dump(spec, f)
    _config(e)
    texts = ["<|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>"]
    ids, _ = _same(TE.json_tokenize_fn(e), JTE.hf_tokenize_fn(e), texts, 16)
    n = len(spec["model"]["vocab"])
    assert ids[0, 1] == n + list(SPECIAL).index("<|start_header_id|>")


def test_reader_refuses_what_it_does_not_take(trained):
    d, _, _ = trained
    with open(os.path.join(d, "tokenizer.json")) as f:
        spec = json.load(f)
    pre = lambda s, i: s["pre_tokenizer"]["pretokenizers"][i]
    for change, msg in (
            (lambda s: pre(s, 0)["pattern"].update(Regex=r"\s+"), "Split"),
            (lambda s: pre(s, 1).update(use_regex=True), "ByteLevel"),
            (lambda s: s["model"].update(byte_fallback=True), "byte_fallback"),
            (lambda s: s["model"].update(dropout=0.1), "dropout"),
            (lambda s: s["post_processor"]["processors"].append(
                s["post_processor"]["processors"][1]), "more than one template"),
            (lambda s: s.update(pre_tokenizer={"type": "Digits"}), "Digits")):
        s = json.loads(json.dumps(spec))
        change(s)
        with pytest.raises(ValueError, match=msg):
            TJ.TokenizerJSON.from_spec(s, {"pad_token": "<|end_of_text|>"})


def test_from_checkpoint_encodes_with_the_json_tokenizer(jax_weights, trained, tmp_path):
    """``LLMTextEncoder.from_checkpoint``: the tower from HF-named
    safetensors, the tokenizer from ``tokenizer.json``, the official video
    template cropped at 95."""
    _, tp = jax_weights
    d, mine, _ = trained
    hf = {"model.embed_tokens.weight": tp["token_emb"], "model.norm.weight": tp["final_ln"]}
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for i in range(CFG.n_layers):
        b = tp["blocks"]
        hf[f"model.layers.{i}.input_layernorm.weight"] = b["ln_attn"][i]
        hf[f"model.layers.{i}.post_attention_layernorm.weight"] = b["ln_mlp"][i]
        for ours, theirs in names.items():
            hf[f"model.layers.{i}.{theirs}.weight"] = b[ours][i].t()
    path = str(tmp_path / "llm")
    save_file(hf, os.path.join(path, "model.safetensors"))
    # the trained vocabulary and specials exceed the tiny tower's 128 rows
    cfg = L.LlamaConfig(**{**vars(CFG), "vocab": 128})
    enc = TE.LLMTextEncoder.from_checkpoint(path, d, cfg=cfg, device="cpu",
                                            dtype=torch.float32, max_length=8)
    assert enc.prompt_template_video["crop_start"] == 95
    ids, mask = enc.text2tokens(["a cat"], "video")
    np.testing.assert_array_equal(ids, mine([TE.HUNYUAN_PROMPT_TEMPLATE_ENCODE_VIDEO.format(
        "a cat")], 103)[0])
    enc.tokenize_fn = lambda texts, n: (np.minimum(mine(texts, n)[0], 127), mine(texts, n)[1])
    hid, m = enc(["a cat"], "video")
    assert hid.shape == (1, 8, CFG.d_model) and m.shape == (1, 8)
    full = L.llama_hidden_states(tp, CFG, np.minimum(ids, 127), mask, hidden_state_skip_layer=2,
                                 dtype=torch.float32)
    np.testing.assert_allclose(hid.numpy(), full[:, 95:].numpy(), rtol=0, atol=1e-6)
