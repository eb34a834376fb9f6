"""Annotation prompt template (port of the parts of
`opus_pllm_tpu/infer/conversation.py` the annotation runner uses:
`VICUNA_V0` :133, `annotation_prompt` :156, `truncate_at_sep` :163)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class Conversation:
    system: str
    roles: List[str]
    sep: str = "###"


VICUNA_V0 = Conversation(
    system="A chat between a curious student and a biological professor who "
           "is familiar with protein properties. The biological professor "
           "gives helpful, detailed, and professional answers to student's "
           "questions.",
    roles=["Student", "Professor"],
)


def annotation_prompt(instruction: str, conv: Conversation = VICUNA_V0) -> str:
    """The manual prompt layout of run_opus_ddp.py:102-107."""
    header = f"{conv.system}\n\n"
    return (header + "### " + conv.roles[0] + ": " + instruction + "\n"
            + "### " + "Professor:")


def truncate_at_sep(text: str, sep: str = "###") -> str:
    """Cut generated text at the first separator (run_opus_ddp.py:19-27)."""
    text = text.strip()
    idx = text.find(sep)
    if idx == -1:
        return text
    return text[:idx].strip()
