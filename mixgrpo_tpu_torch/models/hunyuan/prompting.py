"""HunyuanVideo prompt handling: the LLM encoder's instruction templates and
prompt rewriting.

Port of mixgrpo_tpu/models/hunyuan/prompting.py, copied whole (plain
Python): prompts are wrapped in a describe-the-video instruction before
encoding, ``crop_start`` counts the template's tokens ahead of the prompt
(cropped off the encoder's output), and ``rewrite_prompt`` passes a prompt
through an instruction-following LLM callable (identity without one).  The
official templates of the released checkpoint are in ``text_encoder.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

# Instruction wrappers for the LLM text encoder.  ``crop_start`` = number
# of template tokens preceding the user prompt in the encoded sequence
# (depends on the tokenizer; set per deployment like the reference's
# constants).
PROMPT_TEMPLATES = {
    "li-dit-encode-video": {
        "template": (
            "Describe the video precisely, covering: the subjects and their "
            "appearance; the actions taking place; the setting and "
            "background; camera framing and motion; lighting, color and "
            "overall atmosphere.\n{}"
        ),
        "crop_start": 95,
    },
    "li-dit-encode-image": {
        "template": (
            "Describe the image precisely: subjects and their appearance, "
            "composition, setting, lighting, color and style.\n{}"
        ),
        "crop_start": 36,
    },
}

NEGATIVE_PROMPT = (
    "blurred, low resolution, mutated, deformed, disfigured, bad anatomy, "
    "ugly, cropped, watermark, text, error, worst quality, jpeg artifacts, "
    "low quality, lowres, extra digits, fewer digits"
)


@dataclasses.dataclass
class VideoInferenceConfig:
    """Legacy video-inference knobs (role parity with the reference's
    grouped argparse config, hunyuan/idle_config.py — including the
    parallel-degree stubs :381-399)."""

    video_size: tuple = (720, 1280)
    video_length: int = 129
    infer_steps: int = 50
    flow_shift: float = 7.0
    embedded_cfg_scale: float = 6.0
    prompt_template: str = "li-dit-encode-video"
    neg_prompt: str = NEGATIVE_PROMPT
    ulysses_degree: int = 1
    ring_degree: int = 1
    seed: int = 42


def apply_prompt_template(prompt: str, template_name: str = "li-dit-encode-video"):
    """Returns (wrapped_prompt, crop_start)."""
    t = PROMPT_TEMPLATES[template_name]
    return t["template"].format(prompt), t["crop_start"]


REWRITE_INSTRUCTION = (
    "Rewrite the following text-to-video prompt into a single dense visual "
    "description. Keep every stated subject, attribute, action and style; "
    "add concrete visual detail for anything underspecified (framing, "
    "motion, lighting, setting); do not add new subjects; answer with the "
    "rewritten prompt only.\nPrompt: {}"
)


def rewrite_prompt(prompt: str, llm: Optional[Callable[[str], str]] = None) -> str:
    """Prompt rewrite pass (hunyuan/prompt_rewrite.py role): pipe the prompt
    through an instruction-following LLM callable; identity without one."""
    if llm is None:
        return prompt
    return llm(REWRITE_INSTRUCTION.format(prompt)).strip()
