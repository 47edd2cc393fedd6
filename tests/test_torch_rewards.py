"""The port's reward zoo against the JAX package on the CPU, in f32, at tiny
geometries (``CLIPConfig``-shaped towers of width 32, BLIP's ``tiny``).

- ``clip_preprocess`` and ``blip_preprocess`` at up- and down-scales, square
  and not, within 1e-5 (both are Keys-cubic resizes with antialiasing).
- HPSv2.1, PickScore and CLIP-score loaded by each package's
  ``from_checkpoint`` from the same files (an F16 OpenCLIP ``.pt`` nested
  under ``state_dict``, an HF ``CLIPModel`` directory written by the port's
  ``save_file``, a quick-GELU OpenCLIP ``.bin`` beside its
  ``open_clip_config.json``; the files are written by ``chip_smoke.py``'s
  writers), scoring the same images and prompts within 1e-4; PickScore
  against its formula; ``logit_scale`` kept in f32 under bf16 weights.
- ``compute_reward``'s four return values, exactly.
- UnifiedReward through a stub session, against JAX's on the same stub:
  order, a retry (``time.sleep`` patched in both), parse failures, the
  "semantic" template; exactly.  And the port's own ``urllib`` session
  against a stub server on 127.0.0.1 (HTTP 500 once, a reply with no score).
- ``is_answer_match`` and ``VQAScorer`` on the cases of tests/test_misc.py.
- The port's BERT WordPiece tokenizer (``vocab.txt`` and ``tokenizer.json``)
  against ``transformers.BertTokenizerFast`` on a synthetic vocabulary, id
  for id and mask for mask (accents, CJK, punctuation, a word over 100
  characters, truncation to 35, padding, special tokens in the text).
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from mixgrpo_tpu.rewards import base as JBase
from mixgrpo_tpu.rewards import clip_family as JCF
from mixgrpo_tpu.rewards import unified_reward as JUR
from mixgrpo_tpu.rewards import vqa as JVQA
from mixgrpo_tpu.rewards.image_reward import blip_preprocess as j_blip_preprocess
from mixgrpo_tpu.rewards.preprocess import clip_preprocess as j_clip_preprocess
from mixgrpo_tpu_torch.models.text.clip import CLIPConfig, CLIPTowerConfig, init_clip
from mixgrpo_tpu_torch.models.text.clip_load import load_torch_state
from mixgrpo_tpu_torch.models.text.tokenizer_json import load_bert_tokenizer
from mixgrpo_tpu_torch.rewards import base as Base
from mixgrpo_tpu_torch.rewards import clip_family as CF
from mixgrpo_tpu_torch.rewards import unified_reward as UR
from mixgrpo_tpu_torch.rewards import vqa as VQA
from mixgrpo_tpu_torch.rewards.image_reward import blip_preprocess
from mixgrpo_tpu_torch.rewards.preprocess import clip_preprocess
from mixgrpo_tpu_torch.utils.safetensors_io import save_file

PROMPTS = ["a photo of the cat", "the dog on a mat", "Café crème, 東京! #2"]


def tiny_clip(image_size=32, quick_gelu=False):
    """A CLIP whose text vocabulary covers the ids of ``CS.CLIP_MERGES``
    (512 byte tokens + merges + 2 specials) at the tokenizer's 77 positions."""
    return CLIPConfig(
        embed_dim=16,
        vision=CLIPTowerConfig(width=32, layers=2, heads=2, patch=8, image_size=image_size),
        text=CLIPTowerConfig(width=32, layers=2, heads=2, vocab=640, context=77),
        quick_gelu=quick_gelu)


def write_clip_ckpts(d):
    """HPS (F16 ``.pt``, tiny config JSON beside it), PickScore (HF dir, F32
    safetensors) and CLIP-score (quick-GELU F32 ``.bin``) files plus the
    merges table under ``d``; returns their paths."""
    os.makedirs(d, exist_ok=True)
    merges = os.path.join(d, "merges.txt")
    with open(merges, "w") as f:
        f.write("\n".join(CS.CLIP_MERGES) + "\n")
    gen = lambda s: torch.Generator().manual_seed(s)
    hps_cfg, cs_cfg = tiny_clip(32), tiny_clip(48, quick_gelu=True)
    os.makedirs(os.path.join(d, "hps"), exist_ok=True)
    hps = os.path.join(d, "hps", "HPS_v2.1_compressed.pt")
    st = CS.openclip_state(init_clip(hps_cfg, generator=gen(1), device="cpu"))
    torch.save({"state_dict": {k: v.to(torch.float16).contiguous() for k, v in st.items()}},
               hps)
    with open(os.path.join(d, "hps", "open_clip_config.json"), "w") as f:
        json.dump(CS.openclip_config_json(hps_cfg), f)
    pick = os.path.join(d, "pick")
    save_file(CS.hf_clip_state(init_clip(hps_cfg, generator=gen(2), device="cpu")),
              os.path.join(pick, "model.safetensors"))
    with open(os.path.join(pick, "config.json"), "w") as f:
        json.dump(CS.hf_clip_config_json(hps_cfg), f)
    os.makedirs(os.path.join(d, "dfn"), exist_ok=True)
    cs = os.path.join(d, "dfn", "open_clip_pytorch_model.bin")
    st = CS.openclip_state(init_clip(cs_cfg, generator=gen(3), device="cpu"))
    torch.save({k: v.contiguous() for k, v in st.items()}, cs)
    with open(os.path.join(d, "dfn", "open_clip_config.json"), "w") as f:
        json.dump(CS.openclip_config_json(cs_cfg), f)
    return {"merges": merges, "hps": hps, "pick_score": pick, "clip_score": cs}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return write_clip_ckpts(str(tmp_path_factory.mktemp("rewards")))


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,size", [((2, 72, 72, 3), 32), ((2, 20, 20, 3), 32),
                                        ((1, 48, 80, 3), 32), ((1, 90, 30, 3), 24),
                                        ((2, 32, 32, 3), 32), ((1, 720, 720, 3), 224)])
def test_preprocess_matches_jax(shape, size):
    x = _images(shape)
    got = clip_preprocess(torch.from_numpy(x), size).numpy()
    want = np.asarray(j_clip_preprocess(jnp.asarray(x), size))
    assert got.shape == want.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got = blip_preprocess(torch.from_numpy(x), size).numpy()
    want = np.asarray(j_blip_preprocess(jnp.asarray(x), size))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the CLIP family
# ---------------------------------------------------------------------------

CLASSES = {"hps": (CF.HPSReward, JCF.HPSReward),
           "pick_score": (CF.PickScoreReward, JCF.PickScoreReward),
           "clip_score": (CF.CLIPScoreReward, JCF.CLIPScoreReward)}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_clip_rewards_match_jax(ckpts, name):
    mine_cls, jax_cls = CLASSES[name]
    mine = mine_cls.from_checkpoint(ckpts[name], ckpts["merges"], device="cpu")
    ref = jax_cls.from_checkpoint(ckpts[name], ckpts["merges"], dtype=jnp.float32)
    assert mine.dtype == torch.float32 and mine.cfg.quick_gelu == (name == "clip_score")
    assert mine.cfg.vision.image_size == ref.cfg.vision.image_size
    imgs = _images((3, 40, 56, 3), seed=1)
    got, ok = mine(torch.from_numpy(imgs), PROMPTS)
    want, jok = ref(imgs, PROMPTS)
    assert ok == jok == [1.0] * 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert len(set(np.round(got, 6))) == 3  # the prompts and images are told apart


def test_pick_score_formula_and_f32_logit_scale(ckpts):
    """PickScore is (exp(logit_scale) * cos - 18) / 8; under bf16 weights
    ``logit_scale`` stays f32."""
    m = CF.PickScoreReward.from_checkpoint(ckpts["pick_score"], ckpts["merges"], device="cpu")
    imgs = torch.from_numpy(_images((2, 32, 32, 3), seed=2))
    ids = m.tokenizer(PROMPTS[:2])
    img, txt = m.features(imgs, ids)
    cos = (img.double() * txt.double()).sum(-1)
    want = (torch.exp(m.params["logit_scale"].double()) * cos - 18) / 8
    torch.testing.assert_close(m.score(imgs, ids).double(), want, rtol=0, atol=1e-5)
    b = CF.PickScoreReward.from_checkpoint(ckpts["pick_score"], ckpts["merges"], device="cpu",
                                           dtype=torch.bfloat16)
    assert b.params["vision"]["proj"].dtype == torch.bfloat16
    assert b.params["logit_scale"].dtype == torch.float32
    assert b.params["logit_scale"] == m.params["logit_scale"]


def test_clip_score_warns_without_config(ckpts, tmp_path):
    bare = tmp_path / "model.bin"
    os.link(ckpts["clip_score"], bare)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with pytest.raises(KeyError):  # the tiny file has 2 blocks, not ViT-H-14/384's 32
            CF.CLIPScoreReward.from_checkpoint(str(bare), device="cpu")
    assert any("open_clip_config.json" in str(x.message) for x in w)


def test_load_torch_state_is_memory_mapped(ckpts):
    st = load_torch_state(ckpts["hps"])
    want = torch.load(ckpts["hps"], weights_only=True)["state_dict"]
    assert sorted(st) == sorted(want)
    assert all(torch.equal(st[k], want[k]) and st[k].dtype == torch.float16 for k in want)
    # mmap'd storages are file-backed: they are not resizable heap storages
    assert not st["visual.proj"].untyped_storage().resizable()


# ---------------------------------------------------------------------------
# aggregation, HTTP, VQA
# ---------------------------------------------------------------------------


class _Fake:
    def __init__(self, vals, ok):
        self.vals, self.ok = vals, ok

    def __call__(self, images, prompts):
        return list(self.vals), list(self.ok)


def test_compute_reward_matches_jax():
    models = {"a": _Fake([1.0, 2.0, 3.5], [1.0, 1.0, 0.0]),
              "b": _Fake([10.0, 20.0, -4.0], [1.0, 0.0, 1.0]),
              "c": _Fake([0.25, 0.5, 0.75], [True, True, True])}
    w = {"a": 1.0, "b": 0.5}
    assert Base.compute_reward(None, ["x", "y", "z"], models, w) == \
        JBase.compute_reward(None, ["x", "y", "z"], models, w)


class _Resp:
    def __init__(self, content):
        self._c = content

    def raise_for_status(self):
        pass

    def json(self):
        return {"choices": [{"message": {"content": self._c}}]}


class _Session:
    """Answers each question by its caption; fails the first ``fail_first``
    calls."""

    def __init__(self, answers, fail_first=0):
        self.answers, self.fail_first = answers, fail_first
        self.calls, self.payloads = 0, []

    def post(self, url, json=None, timeout=None):
        self.calls += 1
        self.payloads.append((url, json, timeout))
        if self.calls <= self.fail_first:
            raise RuntimeError("boom")
        text = json["messages"][0]["content"][0]["text"]
        return _Resp(self.answers[text.rsplit("Text Caption: [", 1)[1][:-1]])


@pytest.mark.parametrize("case", ["order", "retry", "parse_failures", "semantic"])
def test_unified_reward_matches_jax_on_stub(case, monkeypatch):
    monkeypatch.setattr(UR.time, "sleep", lambda s: None)
    monkeypatch.setattr(JUR.time, "sleep", lambda s: None)
    prompts = [f"prompt {i}" for i in range(6)]
    qt, fail, workers = None, 0, 4
    answers = {p: f"Final Score: {1 + 0.5 * i}" for i, p in enumerate(prompts)}
    if case == "retry":
        fail, workers = 2, 1
    elif case == "parse_failures":
        answers[prompts[1]] = "garbage"
        answers[prompts[4]] = "Final Score: 7"  # out of the 0-5 range
    elif case == "semantic":
        qt = "semantic"
        answers = {p: f"Alignment Score (1-5): {i % 5}\nStyle Score (1-5): 2"
                   for i, p in enumerate(prompts)}
        answers[prompts[2]] = "Final Score: 3"
    imgs = _images((6, 8, 8, 3), seed=3)
    out = {}
    for mod, images in ((UR, torch.from_numpy(imgs)), (JUR, imgs)):
        sess = _Session(dict(answers), fail_first=fail)
        r = mod.UnifiedReward("http://stub/", num_workers=workers, session=sess)
        out[mod] = (r(images, prompts, question_type=qt), sess.calls,
                    sorted(json.dumps(p[1], sort_keys=True) for p in sess.payloads),
                    sorted({(p[0], p[2]) for p in sess.payloads}))
    assert out[UR] == out[JUR]
    (scores, ok), calls = out[UR][0], out[UR][1]
    assert calls == 6 + fail
    if case == "order":
        assert scores == [1 + 0.5 * i for i in range(6)] and all(ok)


def test_unified_reward_urllib_session_against_local_server(monkeypatch):
    """The default session (``urllib``) against ``chip_smoke.StubVLM`` on
    127.0.0.1: an HTTP 500 is retried, a reply with no score fails, order is
    kept."""
    monkeypatch.setattr(UR.time, "sleep", lambda s: None)
    prompts = list(CS.REWARD_PROMPTS[:9])
    with CS.StubVLM() as stub:
        scores, ok = UR.UnifiedReward(stub.url, num_workers=3)(
            torch.from_numpy(_images((9, 8, 8, 3))), prompts)
        assert stub.requests == len(prompts) + 1
    want = [CS.StubVLM.score(i) for i in range(9)]
    assert scores == want and ok == [w is not None for w in want]
    assert not ok[CS.UR_NO_SCORE] and ok[CS.UR_FAIL_ONCE]



def test_failed_unified_reward_item_is_masked_not_fatal(tmp_path, monkeypatch):
    """The JAX fault: UnifiedReward scores an item it could not score as
    ``None`` and ``compute_reward`` calls ``float`` on it
    (``mixgrpo_tpu/rewards/base.py:41``), so training stops with a
    ``TypeError`` at the first failed request; ``eval_rewards``' single-image
    mode fails the same way (``mixgrpo_tpu/eval_rewards.py:128``).  The port
    gives the item the score 0.0 and the success 0, and the advantages leave
    it out of its group's statistics."""
    from PIL import Image

    from mixgrpo_tpu import eval_rewards as JEval
    from mixgrpo_tpu_torch import eval_rewards as Eval
    from mixgrpo_tpu_torch.rl import advantage as A

    monkeypatch.setattr(UR.time, "sleep", lambda s: None)
    monkeypatch.setattr(JUR.time, "sleep", lambda s: None)
    prompts = [f"prompt {i}" for i in range(4)]
    answers = {p: f"Final Score: {1 + i}" for i, p in enumerate(prompts)}
    answers[prompts[2]] = "no score in this reply"
    imgs = _images((4, 8, 8, 3), seed=5)
    jm = {"unified_reward": JUR.UnifiedReward("http://stub/", num_workers=2,
                                              session=_Session(dict(answers))),
          "a": _Fake([0.5] * 4, [1.0] * 4)}
    with pytest.raises(TypeError):
        JBase.compute_reward(imgs, prompts, jm, {"a": 1.0})
    pm = {"unified_reward": UR.UnifiedReward("http://stub/", num_workers=2,
                                             session=_Session(dict(answers))),
          "a": _Fake([0.5] * 4, [1.0] * 4)}
    total, ok, rd, sd = Base.compute_reward(torch.from_numpy(imgs), prompts, pm, {"a": 1.0})
    assert rd["unified_reward"] == [1.0, 2.0, 0.0, 4.0]
    assert sd["unified_reward"] == [1.0, 1.0, 0.0, 1.0] and ok == [1.0, 1.0, 0.0, 1.0]
    assert total == [1.5, 2.5, 0.5, 4.5] and all(np.isfinite(total))
    rdt = {k: torch.tensor(v) for k, v in rd.items()}
    sdt = {k: torch.tensor(v) for k, v in sd.items()}
    adv = A.masked_mix_advantages(rdt, sdt, {"unified_reward": 1.0, "a": 1.0}, 4, 0.0)
    assert torch.isfinite(adv).all() and adv[2] == 0.0

    path = str(tmp_path / "one.png")
    Image.fromarray((imgs[2] * 255).astype(np.uint8)).save(path)
    one = lambda mod: {"unified_reward": mod.UnifiedReward(
        "http://stub/", session=_Session({prompts[2]: answers[prompts[2]]}))}
    with pytest.raises(TypeError):
        JEval.score_single_image(path, prompts[2], one(JUR))
    assert Eval.score_single_image(path, prompts[2], one(UR)) == {
        "unified_reward_reward": 0.0, "unified_reward_success": False}

@pytest.mark.parametrize("ans", ["(b) 7 years", "(B)", "7 years", "b", "  B  ", "(a) 5 years",
                                 "blah b blah", "7", "", "(b)7 years", "B)"])
def test_is_answer_match_matches_jax(ans):
    for gold in ("(b) 7 years", "(a) yes", "no option"):
        assert VQA.is_answer_match(ans, gold) == JVQA.is_answer_match(ans, gold)


def test_vqa_scorer_matches_jax():
    answers = {"Is there a cat?": "(a) yes", "What color?": "(b) red"}

    def vlm(image, question):
        for q, a in answers.items():
            if q in question:
                return a if image == "img0" else "(c) wrong"
        return "?"

    meta = [{"qa": {"relation": [{"question": "Is there a cat?", "answer": "(a) yes"}],
                    "attribute": [{"question": "What color?", "answer": "(b) red"}]}}] * 2 + \
        [{"qa": {"relation": [], "attribute": []}}]
    got = VQA.VQAScorer(vlm)(["img0", "img1", "img2"], ["p"] * 3, meta)
    want = JVQA.VQAScorer(vlm)(["img0", "img1", "img2"], ["p"] * 3, meta)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert VQA.DEFAULT_QA_TEMPLATE == JVQA.DEFAULT_QA_TEMPLATE


# ---------------------------------------------------------------------------
# the BERT WordPiece tokenizer
# ---------------------------------------------------------------------------

BERT_WORDS = ["a", "photo", "of", "cat", "dog", "the", "caf", "##e", "cafe", "creme", "brulee",
              "naive", "art", "tokyo", "东", "京", "!", ",", ".", "'", "s", "##s", "un",
              "##believ", "##able", "believ", "x", "##x", "$", "^", "(", ")", "-", "hello",
              "world", "##o", "hell", "é", "[", "]", "mask", "σ", "ς", "##σ", "on", "mat"]
BERT_TEXTS = ["A photo of a CAT!", "Café crème brûlée, naïve art", "东京 tokyo東京",
              "unbelievable dogs's", "x" * 150, "xxxx", "hello\tworld\x00​  (dog) $x^",
              "the " * 40, "", "a [MASK] cat [CLS]", "Hello world. " * 3, "ΣΑΣ σς",
              "a cat　dog on a mat", "zzz cat", "ÅNGSTRÖM café́"]


def bert_vocab_dir(d, words=BERT_WORDS):
    """A ``vocab.txt`` directory: [PAD], 3 unused, [UNK], [CLS], [SEP],
    [MASK], then ``words``."""
    os.makedirs(d, exist_ok=True)
    head = ["[PAD]"] + [f"[unused{i}]" for i in range(3)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    with open(os.path.join(d, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(head + list(words)) + "\n")
    return d


@pytest.mark.parametrize("layout", ["vocab_txt", "tokenizer_json"])
def test_bert_tokenizer_matches_transformers(tmp_path, layout):
    from transformers import BertTokenizerFast

    d = bert_vocab_dir(str(tmp_path / "vocab"))
    if layout == "tokenizer_json":
        BertTokenizerFast.from_pretrained(d).save_pretrained(str(tmp_path / "fast"))
        d = str(tmp_path / "fast")
        os.remove(os.path.join(d, "vocab.txt")) if os.path.exists(
            os.path.join(d, "vocab.txt")) else None
        assert os.path.exists(os.path.join(d, "tokenizer.json"))
    hf, mine = BertTokenizerFast.from_pretrained(d), load_bert_tokenizer(d)
    kw = dict(padding="max_length", truncation=True, max_length=35, return_tensors="np")
    want, got = hf(BERT_TEXTS, **kw), mine(BERT_TEXTS, **kw)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    assert got["input_ids"][4, 1] == 4  # a word over 100 characters is [UNK]
    assert got["attention_mask"][7].all() and got["input_ids"][7, -1] == 6  # truncated: [SEP]


def test_bert_tokenizer_needs_a_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocab.txt"):
        load_bert_tokenizer(str(tmp_path))
