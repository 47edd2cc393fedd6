"""UnifiedReward: VLM scoring over an OpenAI-style HTTP endpoint.

Port of mixgrpo_tpu/rewards/unified_reward.py (host-side Python; the VLM
server is external), with the standard library's ``urllib.request`` in place
of ``requests``:
  - POST ``{api_url}/v1/chat/completions`` with the question text plus the
    image as a base64 PNG data URL, model "UnifiedReward", temperature 0,
    max_tokens 4096;
  - per-item retry x3 with exponential backoff capped at 10 s
    (``min(2**attempt, 10)``) and a timeout growing ``30 + 5*attempt``;
  - a thread pool that keeps the input order;
  - two question templates ("score" and word-wise "semantic") and their
    score parsers ``Final Score: X`` / ``Alignment Score (1-5): X``;
  - returns ``(results, successes)`` with None/False on failure: a failure
    is never turned into a score.

The only reward model that brings images to the host: a batch on the card
is copied once and PNG-encoded with PIL.  ``session`` is any object with
``.post(url, json=, timeout=)`` whose response has ``.raise_for_status()``
and ``.json()`` (tests pass a stub).
"""

from __future__ import annotations

import base64
import concurrent.futures
import io
import json as _json
import re
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

QUESTION_TEMPLATE_SCORE = (
    "You are given a text caption and a generated image based on that caption. "
    "Your task is to evaluate this image based on two key criteria:\n"
    "1. Alignment with the Caption: Assess how well this image aligns with the "
    "provided caption. Consider the accuracy of depicted objects, their "
    "relationships, and attributes as described in the caption.\n"
    "2. Overall Image Quality: Examine the visual quality of this image, "
    "including clarity, detail preservation, color accuracy, and overall "
    "aesthetic appeal.\n"
    "Extract key elements from the provided text caption, evaluate their "
    "presence in the generated image using the format: 'element (type): value' "
    "(where value=0 means not generated, and value=1 means generated), and "
    "assign a score from 1 to 5 after 'Final Score:'.\n"
    "Your task is provided as follows:\nText Caption: [{}]"
)

QUESTION_TEMPLATE_SEMANTIC = (
    "You are presented with a generated image and its associated text caption. "
    "Your task is to analyze the image across multiple dimensions in relation "
    "to the caption. Specifically:\n\n"
    "1. Evaluate each word in the caption based on how well it is visually "
    "represented in the image. Assign a numerical score to each word using the "
    "format:\n"
    '   Word-wise Scores: [["word1", score1], ["word2", score2], ..., '
    '["wordN", scoreN], ["[No_mistakes]", scoreM]]\n'
    "   - A higher score indicates that the word is less well represented in "
    "the image.\n"
    "   - The special token [No_mistakes] represents whether all elements in "
    "the caption were correctly depicted. A high score suggests no mistakes; a "
    "low score suggests missing or incorrect elements.\n\n"
    "2. Provide overall assessments for the image along the following axes "
    "(each rated from 1 to 5):\n"
    "- Alignment Score: How well the image matches the caption in terms of "
    "content.\n"
    "- Coherence Score: How logically consistent the image is (absence of "
    "visual glitches, object distortions, etc.).\n"
    "- Style Score: How aesthetically appealing the image looks, regardless of "
    "caption accuracy.\n\n"
    "Output your evaluation using the format below:\n\n"
    "---\n\n"
    'Word-wise Scores: [["word1", score1], ..., [["[No_mistakes]", scoreM]]\n\n'
    "Alignment Score (1-5): X\n"
    "Coherence Score (1-5): Y\n"
    "Style Score (1-5): Z\n\n"
    "Your task is provided as follows:\nText Caption: [{}]"
)



def _png_data_url(image) -> str:
    from PIL import Image as PILImage

    if isinstance(image, np.ndarray):
        arr = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
        pil = PILImage.fromarray((arr * 255).astype(np.uint8))
    else:
        pil = image  # already a PIL image
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    return f"data:image/png;base64,{b64}"


def extract_final_score(text: str) -> Optional[float]:
    m = re.search(r"Final Score:\s*([0-5](?:\.\d+)?)", text)
    return float(m.group(1)) if m else None


def extract_alignment_score(text: str) -> Optional[float]:
    m = re.search(r"Alignment Score \(1-5\):\s*([0-5](?:\.\d+)?)", text)
    return float(m.group(1)) if m else None


class HTTPResponse:
    """What ``UrllibSession.post`` returns: the status and the body."""

    def __init__(self, url: str, status: int, body: bytes):
        self.url, self.status_code, self.content = url, status, body

    def raise_for_status(self):
        if self.status_code >= 400:
            raise RuntimeError(f"HTTP {self.status_code} from {self.url}")

    def json(self):
        return _json.loads(self.content)


class UrllibSession:
    """``requests.Session().post`` for JSON bodies, on ``urllib.request``."""

    def post(self, url: str, json=None, timeout=None) -> HTTPResponse:
        req = urllib.request.Request(url, data=_json.dumps(json).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return HTTPResponse(url, r.status, r.read())
        except urllib.error.HTTPError as e:
            return HTTPResponse(url, e.code, e.read())


def _host_images(images) -> List[np.ndarray]:
    """(B, H, W, 3) images (a tensor on any device, or numpy, or a list of
    arrays or PIL images) as a list of host arrays, one copy for a tensor."""
    if hasattr(images, "detach"):  # a torch tensor, possibly on the card
        return list(images.detach().float().cpu().numpy())
    return list(images)


class UnifiedReward:
    name = "unified_reward"

    def __init__(
        self,
        api_url: Union[str, Sequence[str]],
        default_question_type: str = "score",
        num_workers: int = 8,
        max_retries: int = 3,
        session=None,
        rank: int = 0,
    ):
        # several URLs are round-robined by rank; a comma-separated string too
        if isinstance(api_url, str):
            urls = [u.strip() for u in api_url.split(",") if u.strip()]
        else:
            urls = list(api_url)
        self.api_url = urls[rank % len(urls)].rstrip("/")
        self.default_question_type = default_question_type
        self.num_workers = num_workers
        self.max_retries = max_retries
        self._session = session  # injectable for tests

    def _get_session(self):
        if self._session is None:
            self._session = UrllibSession()
        return self._session

    def build_question(self, prompt: str, question_type: Optional[str] = None) -> str:
        qt = question_type or self.default_question_type
        if qt == "score":
            return QUESTION_TEMPLATE_SCORE.format(prompt)
        if qt == "semantic":
            return QUESTION_TEMPLATE_SEMANTIC.format(prompt)
        raise ValueError(f"Invalid question type: {qt}")

    def parse_score(self, text: str, question_type: Optional[str] = None):
        qt = question_type or self.default_question_type
        if qt == "score":
            return extract_final_score(text)
        if qt == "semantic":
            return extract_alignment_score(text)
        raise ValueError(f"Invalid question type: {qt}")

    def _query_one(self, image, question: str) -> Optional[str]:
        session = self._get_session()
        payload = {
            "model": "UnifiedReward",
            "messages": [{
                "role": "user",
                "content": [
                    {"type": "text", "text": question},
                    {"type": "image_url", "image_url": {"url": _png_data_url(image)}},
                ],
            }],
            "temperature": 0,
            "max_tokens": 4096,
        }
        for attempt in range(1, self.max_retries + 1):
            try:
                resp = session.post(f"{self.api_url}/v1/chat/completions", json=payload,
                                    timeout=30 + attempt * 5)
                resp.raise_for_status()
                return resp.json()["choices"][0]["message"]["content"]
            except Exception:
                if attempt == self.max_retries:
                    return None
                time.sleep(min(2 ** attempt, 10))
        return None

    def __call__(
        self,
        images,
        prompts: Union[str, Sequence[str]],
        question_type: Optional[str] = None,
    ) -> Tuple[List[Optional[float]], List[bool]]:
        images = _host_images(images)
        if isinstance(prompts, str):
            prompts = [prompts] * len(images)
        assert len(prompts) == len(images), "prompts must match images"
        questions = [self.build_question(p, question_type) for p in prompts]

        results: List[Optional[float]] = [None] * len(images)
        successes: List[bool] = [False] * len(images)
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
            futs = {ex.submit(self._query_one, img, q): i
                    for i, (img, q) in enumerate(zip(images, questions))}
            for fut in concurrent.futures.as_completed(futs):
                i = futs[fut]
                out = fut.result()
                if out is not None:
                    score = self.parse_score(out, question_type)
                    if score is not None:
                        results[i] = score
                        successes[i] = True
        return results, successes
