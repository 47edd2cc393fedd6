"""HPSv2.1's score in plain PyTorch: OpenCLIP ViT-H/14 at 224px.

From OpenCLIP's ``VisionTransformer`` and ``TextTransformer`` (the
geometry of ``ViT-H-14.json``) and HPSv2's ``score``: the image resized
(bicubic, antialiased) so its shorter side is 224, centre-cropped,
normalised with OpenAI CLIP's mean and std; 14x14 patches, a class token,
learned positions, a pre-LN, pre-norm blocks (attention, 4x GELU MLP), a
post-LN of the class token and a projection; the text through the causal
tower, taken at the end-of-text token (the largest id), a final LN and a
projection; the score is the cosine of the two.  LayerNorm eps 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess(images01, size: int):
    """(B, H, W, 3) in [0, 1] -> (B, 3, size, size) normalised f32."""
    x = images01.float().permute(0, 3, 1, 2)
    h, w = x.shape[-2:]
    nh, nw = (size, max(round(w * size / h), size)) if h <= w else \
        (max(round(h * size / w), size), size)
    x = F.interpolate(x, size=(nh, nw), mode="bicubic", antialias=True, align_corners=False)
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[..., top:top + size, left:left + size].clamp(0, 1)
    mean = torch.tensor(MEAN, device=x.device)[:, None, None]
    std = torch.tensor(STD, device=x.device)[:, None, None]
    return (x - mean) / std


def _ln(p, x):
    return F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(), p["bias"].float(),
                        1e-5).to(x.dtype)


def _tower(blocks, x, heads, causal):
    B, S, W = x.shape
    mask = torch.full((S, S), float("-inf"), device=x.device).triu(1) if causal else None
    for i in range(blocks["qkv"]["w"].shape[0]):
        b = {k: {n: t[i] for n, t in v.items()} for k, v in blocks.items()}
        h = _ln(b["ln1"], x)
        q, k, v = (t.reshape(B, S, heads, -1).transpose(1, 2)
                   for t in (h @ b["qkv"]["w"] + b["qkv"]["b"]).chunk(3, -1))
        s = q.float() @ k.float().transpose(-1, -2) / math.sqrt(q.shape[-1])
        if mask is not None:
            s = s + mask
        o = (torch.softmax(s, -1) @ v.float()).to(x.dtype).transpose(1, 2).reshape(B, S, W)
        x = x + o @ b["out"]["w"] + b["out"]["b"]
        h = F.gelu(_ln(b["ln2"], x) @ b["fc1"]["w"] + b["fc1"]["b"])
        x = x + h @ b["fc2"]["w"] + b["fc2"]["b"]
    return x


def hps_scores(p, cfg, images01, token_ids, dtype=torch.bfloat16):
    """(B,) f32 cosine scores of images (B, H, W, 3) in [0, 1] against
    token ids (B, context)."""
    v, t = cfg["vision"], cfg["text"]
    pv, pt = p["vision"], p["text"]
    x = preprocess(images01, v["image_size"]).to(dtype)
    x = F.conv2d(x, pv["patch_embed"]["w"].permute(3, 2, 0, 1).to(dtype), stride=v["patch"])
    B = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([pv["class_emb"].expand(B, 1, -1), x], 1) + pv["pos_emb"]
    x = _tower(pv["blocks"], _ln(pv["ln_pre"], x), v["heads"], False)
    img = _ln(pv["ln_post"], x[:, 0]) @ pv["proj"]
    ids = torch.as_tensor(token_ids, device=x.device).long()
    y = pt["token_emb"][ids] + pt["pos_emb"]
    y = _ln(pt["ln_final"], _tower(pt["blocks"], y, t["heads"], True))
    txt = y[torch.arange(B, device=y.device), ids.argmax(-1)] @ pt["proj"]
    img, txt = F.normalize(img.float(), dim=-1), F.normalize(txt.float(), dim=-1)
    return (img * txt).sum(-1)
