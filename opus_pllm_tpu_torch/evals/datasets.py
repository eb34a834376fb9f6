"""Annotation benchmark loader and per-task generation policy (port of the
annotation half of `opus_pllm_tpu/evals/datasets.py`:
`AnnotationExample` :23, `load_annotation_json` :37, `max_new_tokens_for`
:51, `instruction_for` :60)."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List

LOCALIZATION_SUFFIX = "Kindly reply with only one word."


@dataclass
class AnnotationExample:
    instruction: str
    sequence: str
    output: str


def load_annotation_json(path: str) -> List[AnnotationExample]:
    """[{"instruction", "input": <aa sequence>, "output"}]; entries with a
    null or empty input are dropped (run_opus_ddp.py:61-67)."""
    with open(path) as f:
        data = json.load(f)
    return [AnnotationExample(d["instruction"], d["input"], d.get("output", ""))
            for d in data if d.get("input")]


def max_new_tokens_for(file_path: str) -> int:
    f = file_path.lower()
    if "localization" in f:
        return 32
    if "keywords" in f:
        return 128
    return 256


def instruction_for(example: AnnotationExample, file_path: str) -> str:
    """'<seq>\\n' + instruction, plus the one-word suffix glued on for
    localization sets; instructions that carry `<seq>` pass through."""
    instr = example.instruction
    if "<seq>" in instr:
        return instr
    if "localization" in file_path.lower():
        return "<seq>\n" + instr + LOCALIZATION_SUFFIX
    return "<seq>\n" + instr
