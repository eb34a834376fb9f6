"""Plain reference of a LoRA training step: the instruction row as the
reference's trainer lays it out, the next-token cross-entropy over the
answer, its gradients in the LoRA leaves, and AdamW, in float32.

A row is the annotation prompt (byte ids with one `<seq>` sentinel) and
" " + the answer + EOS, cut to `max_len` ids; its labels ignore the
prompt, the protein's soft tokens and padding. The loss is the mean over
every target token of the batch. Each decoder layer runs under
`torch.utils.checkpoint`, so that the fp32 backward fits on the card.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from . import model as ref
from .prompts import annotation_prompt

IGNORE = -100


def row_ids(ex: dict, max_len: int, eos: int = 2):
    """(ids with the sentinel, labels) of one instruction example."""
    p = ref.byte_ids(annotation_prompt(ex["instruction"], "instruction"))
    a = [b + 4 for b in (" " + ex["output"]).encode("utf-8")] + [eos]
    ids = (p + a)[:max_len]
    labels = ([IGNORE] * len(p) + a)[:max_len]
    return ids, labels


def _spliced(params, spec, ex, max_len, prec):
    ids, labels = row_ids(ex, max_len)
    with torch.no_grad():
        soft = ref.soft_tokens(params, spec, ex["sequence"], prec)
    x = ref.splice_row(params["llm"], ids, soft)
    at = ids.index(ref.SEQ_SENTINEL)
    lab = labels[:at] + [IGNORE] * spec["n_tokens"] + labels[at + 1:]
    return x, lab


def loss_and_grads(params, spec, examples, lora, scaling: float,
                   max_len: int, prec: ref.Precision):
    """-> (mean loss, {leaf path: gradient}, the number of target tokens
    the mean is over) over the LoRA tree `lora` ({"layers": [{proj: {"A",
    "B"}}]}, fp32)."""
    rows, labs = zip(*[_spliced(params, spec, ex, max_len, prec)
                       for ex in examples])
    x, lengths = ref.right_pad(list(rows))
    dev = x.device
    n = x.shape[1]
    tg = torch.full((len(labs), n), IGNORE, dtype=torch.long, device=dev)
    for i, lab in enumerate(labs):
        tg[i, :len(lab)] = torch.tensor(lab, device=dev)
    leaves = {}
    tree = {"layers": []}
    for li, lp in enumerate(lora["layers"]):
        d = {}
        for proj, ab in lp.items():
            d[proj] = {}
            for k, t in ab.items():
                t = t.detach().clone().requires_grad_(True)
                d[proj][k] = t
                leaves[(li, proj, k)] = t
        tree["layers"].append(d)

    def ckpt(i, fn, h):
        return torch.utils.checkpoint.checkpoint(fn, h, use_reentrant=False)

    hid = ref.decoder_hidden(params["llm"], spec, x, lengths, prec,
                             lora=tree, scaling=scaling, layer_fn=ckpt)
    target = tg[:, 1:]
    valid = target != IGNORE
    tot = x.new_zeros(())
    for r in range(hid.shape[0]):
        lg = ref.head(params["llm"], spec, hid[r, :-1], prec)
        nll = -torch.log_softmax(lg, -1).gather(
            1, target[r].clamp_min(0)[:, None])[:, 0]
        tot = tot + torch.where(valid[r], nll, torch.zeros_like(nll)).sum()
    loss = tot / valid.sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (float(loss.detach()), dict(zip(leaves.keys(), grads)),
            int(valid.sum()))


class AdamW:
    """torch.optim.AdamW's update written out: betas (0.9, 0.999), eps
    1e-8, decoupled weight decay."""

    def __init__(self, lr: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = (lr, weight_decay,
                                                        *betas, eps)
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            p = params[k]
            m = self.m.get(k, torch.zeros_like(g)) * self.b1 \
                + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(g)) * self.b2 \
                + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            p.mul_(1 - self.lr * self.wd)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def flat(lora) -> dict:
    """{(layer, proj, "A"|"B"): tensor} of a LoRA tree."""
    return {(li, proj, k): t for li, lp in enumerate(lora["layers"])
            for proj, ab in lp.items() for k, t in ab.items()}
