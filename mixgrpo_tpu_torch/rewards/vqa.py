"""VQA-checklist reward: score = fraction of QA pairs answered correctly.

Port of mixgrpo_tpu/rewards/vqa.py (pure Python and numpy; the port imports
nothing of the JAX package, so it keeps its own copy):

  - each image carries metadata ``qa = {"relation": [...], "attribute":
    [...]}`` of {question, answer} dicts;
  - a VLM answers each question: any callable ``(pil_image_or_array,
    question_text) -> answer_str``, with an adapter for an HF
    ``image-text-to-text`` pipeline object (``hf_pipeline_vlm``, which
    imports nothing of HF itself);
  - answer matching accepts the full "(b) 7 years", the bare option "(b)",
    the bare description "7 years", or the standalone letter "b"
    (case/whitespace-insensitive exact matches);
  - image score = matched / total questions.
"""

from __future__ import annotations

import re
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np

DEFAULT_QA_TEMPLATE = (
    "Based on the image, answer the following question by strictly selecting "
    "only one option from the given choices.\nQuestion: {question}\nAnswer:"
)


def is_answer_match(ans: str, should: str) -> bool:
    """Match a generated answer against the gold "(b) 7 years" form."""
    ans = ans.lower().strip()
    should = should.lower().strip()
    option_part = should.split(")")[0] + ")"  # "(b)"
    try:
        desc_part = should.split(") ", 1)[1]  # "7 years"
    except IndexError:
        desc_part = should
    option_letter = option_part[1] if len(option_part) > 1 else option_part
    pattern = (
        rf"^({re.escape(should)}|{re.escape(option_part)}|"
        rf"{re.escape(desc_part)}|\b{re.escape(option_letter)}\b)$"
    )
    return bool(re.fullmatch(pattern, ans))


class VQAScorer:
    def __init__(
        self,
        vlm: Callable[[Any, str], str],
        template: str = DEFAULT_QA_TEMPLATE,
    ):
        self.vlm = vlm
        self.template = template

    def __call__(
        self,
        images: Sequence[Any],
        prompts: Sequence[str],
        metadata: Sequence[dict],
    ) -> Tuple[np.ndarray, List[float]]:
        scores = np.zeros(len(images), np.float64)
        for i, (image, meta) in enumerate(zip(images, metadata)):
            qa = meta["qa"]
            all_qa = list(qa.get("relation", [])) + list(qa.get("attribute", []))
            if not all_qa:
                continue
            hit = 0
            for item in all_qa:
                answer = self.vlm(image, self.template.format(question=item["question"]))
                if is_answer_match(answer, item["answer"]):
                    hit += 1
            scores[i] = hit / len(all_qa)
        return scores, [1.0] * len(images)


def hf_pipeline_vlm(vqa_pipeline, max_new_tokens: int = 512):
    """Adapter for an HF ``image-text-to-text`` pipeline object."""

    def vlm(image, question: str) -> str:
        if not hasattr(image, "save"):  # numpy array -> PIL
            from PIL import Image as PILImage

            arr = np.clip(np.asarray(image, np.float32), 0, 1)
            image = PILImage.fromarray((arr * 255).astype(np.uint8))
        messages = [{
            "role": "user",
            "content": [
                {"type": "image", "image": image},
                {"type": "text", "text": question},
            ],
        }]
        out = vqa_pipeline(
            text=[messages], max_new_tokens=max_new_tokens, return_full_text=False
        )
        return out[0][0]["generated_text"]

    return vlm
