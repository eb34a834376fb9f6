"""HF tokenizer wrapper with the reference's per-family fixups (port of
`opus_pllm_tpu/infer/hf_tokenizer.py`).

A local transformers tokenizer behind the encode / decode surface the
port uses (infer/tokenization.py), with the pad / unk / eos adjustments of
load_pretrained_model (model/builder.py:69-94):
  llama : pad = unk = eos
  opt   : pad '<pad>', unk '<unk>', eos '</s>'
  qwen2 : the tokenizer as it is (pad falls back to eos)
`transformers` is imported when a tokenizer is built, not with this
module: it is the one part of the port that needs the package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class HFTokenizer:
    def __init__(self, path: str, family: Optional[str] = None):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path, use_fast=True,
                                                local_files_only=True)
        if family is None:
            from ..core.builder import family_from_path
            try:
                family = family_from_path(path)
            except NotImplementedError:
                family = "llama"
        self.family = family
        if family == "llama":
            self.tk.pad_token = self.tk.eos_token
            self.pad_token_id = self.eos_token_id = self.tk.eos_token_id
        elif family == "opt":
            self.pad_token_id = self.tk.convert_tokens_to_ids("<pad>")
            self.eos_token_id = self.tk.convert_tokens_to_ids("</s>")
        else:
            self.pad_token_id = (self.tk.pad_token_id
                                 if self.tk.pad_token_id is not None
                                 else self.tk.eos_token_id)
            self.eos_token_id = self.tk.eos_token_id
        # a BOS only where the tokenizer itself emits one (Llama-3 does,
        # byte-level GPT2-style ones do not), as tokenizer_seq_token keeps
        # a single leading BOS (mm_utils.py:12-32)
        bos = self.tk.bos_token_id
        if bos is not None:
            probe = self.tk.encode("a", add_special_tokens=True)
            if not probe or probe[0] != bos:
                bos = None
        self.bos_token_id = bos
        self.vocab_size = len(self.tk)

    def encode(self, text: str) -> List[int]:
        return self.tk.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=True)

    def apply_chat_template(self, messages, add_generation_prompt=True) -> str:
        if not getattr(self.tk, "chat_template", None):
            # a template-less tokenizer gets the reference's own fallback
            # template (eval_run_multichoice.py:75), whitespace and all
            from .conversation import REFERENCE_CHATML_TEMPLATE
            self.tk.chat_template = REFERENCE_CHATML_TEMPLATE
        return self.tk.apply_chat_template(
            messages, tokenize=False,
            add_generation_prompt=add_generation_prompt)
