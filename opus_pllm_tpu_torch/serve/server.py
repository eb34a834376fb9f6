"""HTTP serving front for the continuous-batching engine (port of
`opus_pllm_tpu/serve/server.py`).

A stdlib-only (http.server) JSON endpoint over one `ServingEngine`. The
multimodal front keeps the reference REPL's contract (the professor
prompt, amino-acid validation, '###' truncation, run_opus_online.py:12-54)
while the engine underneath batches continuously.

Endpoints (JSON):
  POST /v1/annotate  {"instruction", "sequence", "max_new_tokens"?,
                      "temperature"?, "top_p"?, "adapter"?,
                      "stream"?}                 -> {"text", ...}
  POST /v1/generate  {"prompt", "max_new_tokens"?, "temperature"?}
                      (text-only, no protein)    -> {"text", ...}
  POST /v1/chat/completions, /v1/completions, /v1/embeddings,
  GET  /v1/models                                -> OpenAI-compatible
                                                    (serve/openai_api.py)
  GET  /v1/adapters, DELETE /v1/adapters/NAME    -> the adapter bank
  POST /v1/adapters {"name", "path"}             -> load a PEFT adapter
                                                    directory into a free
                                                    bank row
  GET  /health                                   -> engine counters +
                                                    latency means
  GET  /metrics                                  -> Prometheus exposition

Threading: HTTP handlers (ThreadingHTTPServer) never touch the engine or a
tensor. They tokenize, then hand the device work (the protein splice, the
embeddings) to the ONE engine thread (`run_on_engine`), enqueue a
ServeRequest and wait on a per-request event. The engine thread owns
submit()/step() and every CUDA call; it sets the engine's device first,
and the engine's sampling generator lives on that device.

`add_adapter` of an in-memory tree works through
`run_on_engine(lambda: srv.engine.add_adapter(name, tree))`. `warmup` is a
no-op (a jit warm-up in the JAX package; PyTorch runs eagerly).

Tensor-parallel serving over several processes (`mesh`, a core.mesh.Mesh
of data 1 and M > 1 ranks; the JAX server is one controller whose HTTP
threads feed one engine over every device): rank 0 runs this server and
HTTP; every other rank runs `serve_follower` over an engine built the same
way. Each iteration of rank 0's engine thread broadcasts one message over
the mesh: the adapter operations it applied (as data: the folded tree's
tensors, a name), the cancellations, the submissions it accepted
(request id, token ids or spliced embeddings, generation options), the
LLM forwards an embeddings request needs, whether to step, and stop.
Every rank applies them in the same order and steps the engine, so the
engines' collectives meet. Closures never cross ranks: `run_on_engine`
stays rank 0's, and only an operation and its data reach the followers.
Rank 0 validates a request (`engine.submit`) before it broadcasts it, so
a follower whose submit raises is out of step: it stops with an error,
as does rank 0 when a step or a broadcast fails. An idle server
broadcasts an empty message every 0.05 s, well inside the process
group's timeout. Rank 0 splices proteins (ESM2 -> CSTP -> switch) and
broadcasts the embeddings: a follower uses the LLM share only (it holds
what the CLI loads on every rank, and never runs the protein tower).
/health and /metrics answer from rank 0; SIGTERM drains rank 0, whose
last message stops the followers.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..bridge import cstp as cstp_mod
from ..core.config import OpusConfig
from ..core.util import round_up
from ..infer.conversation import VICUNA_V0, VICUNA_V3, annotation_prompt, \
    truncate_at_sep
from ..infer.tokenization import pad_batch, tokenize_with_seq
from ..models import esm2, opus, text_encoder
from .engine import Completion, ServeRequest, ServingEngine

STANDARD_AA = set("ACDEFGHIKLMNPQRSTVWY")


class ServerDraining(Exception):
    """New work rejected because the server is shutting down gracefully
    (maps to HTTP 503 so load balancers retry elsewhere)."""


class ServerOverloaded(Exception):
    """New work rejected because the backlog hit --max-queue (maps to
    HTTP 429: shed load at admission instead of queuing unboundedly and
    timing every client out)."""


class LockstepError(RuntimeError):
    """A rank of a tensor-parallel server fell out of step (a follower
    could not apply what rank 0 did, or a collective failed)."""


def system_prefix_ids(tokenizer) -> list:
    """The token ids of the constant conversation header that
    `cache_system_prefix` pins (manual-layout prompts only): the system
    prompt up to the role tag, everything before the first varying
    character of an annotation prompt."""
    header = f"{VICUNA_V0.system}\n\n### {VICUNA_V0.roles[0]}: "
    return tokenize_with_seq(header, tokenizer.encode,
                             getattr(tokenizer, "bos_token_id", None))


def _mesh_src(mesh) -> int:
    """The global rank of the mesh's first rank (the one that serves)."""
    return mesh.ranks[0][0]


def _broadcast(msg, mesh):
    box = [msg]
    dist.broadcast_object_list(box, src=_mesh_src(mesh), group=mesh.group)
    return box[0]


def _wire_request(req: ServeRequest) -> dict:
    """What a follower needs of an accepted request (no callback; the
    embeddings on the host, whatever card they lie on)."""
    emb = req.embeds
    if isinstance(emb, torch.Tensor):
        emb = emb.detach().cpu()
    return {"request_id": req.request_id, "embeds": emb,
            "token_ids": req.token_ids, "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature, "top_p": req.top_p,
            "eos_token_id": req.eos_token_id, "prefix_id": req.prefix_id,
            "adapter_id": req.adapter_id}


def _text_forward(engine: ServingEngine, ids, mask):
    """The LLM half of a text embedding over the engine's (share of the)
    decoder: the part of `opus.text_cstp_embeddings` whose collectives
    every rank of a tensor-parallel server must run."""
    to = lambda a: torch.from_numpy(np.asarray(a)).to(engine.device)
    return text_encoder.text_embeddings(engine.params, engine.cfg, to(ids),
                                        to(mask), mask_pad=True)


def _apply_op(engine: ServingEngine, op) -> None:
    """A follower's replay of an operation rank 0 applied."""
    if op[0] == "add_adapter":
        engine.add_adapter(op[1], op[2])
    elif op[0] == "remove_adapter":
        engine.remove_adapter(op[1])
    elif op[0] == "text_embed":
        with torch.no_grad():
            _text_forward(engine, op[1], op[2])
    else:
        raise LockstepError(f"unknown operation {op[0]!r}")


_COLLECTIVE_OPS = ("text_embed",)


def serve_follower(engine: ServingEngine, mesh, log_fn=print) -> None:
    """A follower rank of a tensor-parallel server: receive rank 0's
    message, apply its operations, cancellations and submissions in rank
    0's order, step when rank 0 steps; return on rank 0's stop. Anything
    that fails here raises LockstepError (the rank exits non-zero).
    SIGTERM is noted and ignored: rank 0 drains, then stops this rank."""
    import signal
    try:
        signal.signal(signal.SIGTERM, lambda *_: log_fn(
            "SIGTERM: this rank follows rank 0's drain"))
    except ValueError:
        pass    # not the main thread
    if engine.device.type == "cuda":
        torch.cuda.set_device(engine.device)
    while True:
        msg = _broadcast(None, mesh)
        try:
            for op in msg["ops"]:
                if op[0] not in _COLLECTIVE_OPS:
                    _apply_op(engine, op)
            for rid in msg["cancels"]:
                engine.cancel(rid)
            for wire in msg["submits"]:
                engine.submit(ServeRequest(**wire))
            for op in msg["ops"]:
                if op[0] in _COLLECTIVE_OPS:
                    _apply_op(engine, op)
        except Exception as e:
            raise LockstepError(f"rank {dist.get_rank()} cannot follow rank "
                                f"0: {type(e).__name__}: {e}") from e
        if msg["stop"]:
            return
        if engine.busy != msg["step"]:
            raise LockstepError(f"rank {dist.get_rank()}: the engine is "
                                f"{'' if engine.busy else 'not '}busy where "
                                f"rank 0's is{'' if msg['step'] else ' not'}")
        if msg["step"]:
            engine.step()


class OpusServer:
    """Multimodal request front + engine thread + HTTP plumbing.

    params/cfg/tokenizer as produced by core.builder (the full
    {esm,cstp,switch,llm} tree); engine kwargs pass through to
    ServingEngine (slots, capacity, buckets, steps_per_tick,
    quantize_cache). `mesh`: tensor-parallel serving; with more than one
    rank this is rank 0 of a lockstep server (module docstring).
    """

    def __init__(self, params, cfg: OpusConfig, tokenizer, *,
                 chat_template: bool = False, prompt_bucket: int = 64,
                 esm_bucket: int = 128, default_max_new: int = 256,
                 model_id: str = "opus-pllm-tpu",
                 cache_system_prefix: bool = False,
                 max_queue: Optional[int] = None, mesh=None,
                 **engine_kwargs):
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        self.chat_template = chat_template
        self.prompt_bucket = prompt_bucket
        self.esm_bucket = esm_bucket
        self.default_max_new = default_max_new
        self.model_id = model_id   # the OpenAI-API served model name
        # prefix caching for the constant professor header: its KV is
        # computed once (engine.register_prefix) and every matching
        # request admits with only its suffix. Manual-layout prompts only
        # (the chat template renders per-model headers); adapter requests
        # fall back (the pinned KV holds base-weight state)
        self.cache_system_prefix = bool(cache_system_prefix)
        self._sys_ids: Optional[list] = None
        self.max_queue = max_queue   # admission backpressure (None: off)
        self.engine = ServingEngine(params["llm"], cfg.llm, mesh=mesh,
                                    **engine_kwargs)
        self.mesh = mesh
        self._lockstep = mesh is not None and mesh.model > 1
        if self._lockstep:
            if dist.get_rank() != _mesh_src(mesh):
                raise ValueError("OpusServer runs on the mesh's first rank; "
                                 "the others run serve_follower")
            # the LLM as the engine holds it (its share): the text
            # embeddings run the followers' collectives on it
            self.params = dict(params, llm=self.engine.params)
            self.cfg = dataclasses.replace(cfg, llm=self.engine.cfg)
        self._fatal: Optional[BaseException] = None
        self._on_fatal = None

        self._pending: "queue.Queue[ServeRequest]" = queue.Queue()
        self._cancels: "queue.Queue[Any]" = queue.Queue()
        # admin ops (adapter add/remove) run ON the engine thread, which
        # owns all engine state: (callable, done event, result box)
        self._admin: "queue.Queue[tuple]" = queue.Queue()
        self._cancelled: set = set()
        # rids enqueued in _pending but not yet submitted to the engine:
        # a cancel racing ahead of the submission (engine busy in a long
        # step/compile when the client gives up) must still take effect,
        # or the request runs as a ghost and leaks its _results entry
        self._unsubmitted: set = set()
        self._events: Dict[Any, threading.Event] = {}
        self._results: Dict[Any, Completion] = {}
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._draining = False
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._register_sys_prefix()   # before the thread owns the engine
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="opus-serve-engine")
        self._thread.start()

    # ------------------------------------------------------------------
    # request fronts
    # ------------------------------------------------------------------

    def _prompt_for(self, instruction: str) -> str:
        if self.chat_template:
            return self.tok.apply_chat_template(
                [{"role": "system", "content": VICUNA_V3.system},
                 {"role": "user", "content": "<seq>\n" + instruction}],
                add_generation_prompt=True)
        return annotation_prompt("<seq>\n" + instruction, VICUNA_V0)

    @torch.no_grad()
    def _splice_ids(self, ids_l: list, sequence: str) -> torch.Tensor:
        """<seq>-sentinel token ids + protein -> exact-length (P, H)
        spliced embeddings on the engine's device: a bucket-padded splice,
        then the valid left-padded tail. Runs on the engine thread."""
        dev = self.engine.device
        ids, mask = pad_batch([ids_l], self.tok.pad_token_id, left=True,
                              max_len=round_up(len(ids_l),
                                               self.prompt_bucket))
        esm_toks, _ = esm2.tokenize(
            [sequence], max_len=round_up(len(sequence) + 2, self.esm_bucket))
        to = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        sp = opus.splice_prompt_left(self.params, self.cfg, to(ids),
                                     to(mask), to(esm_toks)[:, None])
        return sp.embeds[0, sp.mask[0].nonzero()[:, 0]]

    def _register_sys_prefix(self) -> None:
        """Register the constant conversation header ONCE as a pinned KV
        prefix. Called from __init__ BEFORE the engine thread starts (the
        engine thread owns all engine state afterwards; a lazy handler-
        thread registration would race it). The header runs through the
        system prompt up to the role tag — everything before the first
        varying character of an annotation prompt (annotation_prompt:
        f"{system}\\n\\n### {role}: {instruction}")."""
        if not self.cache_system_prefix or self.chat_template:
            return
        ids = system_prefix_ids(self.tok)
        self.engine.register_prefix(
            "sys", token_ids=np.asarray(ids, np.int64))
        self._sys_ids = ids

    def prepare_request(self, prompt: str, sequence: Optional[str], *,
                        adapter: Optional[str] = None) -> dict:
        """prompt (+ optional protein) -> submit kwargs, taking the
        pinned system-prefix path when it applies: the request's first
        tokens must equal the registered header ids exactly (tokenizer
        merges across the boundary fall back to a full admission),
        adapter requests always run full (the pinned KV holds base-weight
        state; engine.submit rejects the combination), and suffixes past
        the largest prefill bucket fall back too (only FULL long prompts
        ride chunked prefill). `_prompt_tokens` counts the full prompt
        either way.

        Text-only prompts (sequence=None) tokenize LITERALLY — a '<seq>'
        in /v1/generate text is content, not a splice marker (there is no
        protein to splice; a sentinel would corrupt the embedding)."""
        bos = getattr(self.tok, "bos_token_id", None)
        if sequence is None:
            ids_l = list(self.token_ids_generate(prompt))
        else:
            ids_l = tokenize_with_seq(prompt, self.tok.encode, bos)
        sys_ids = self._sys_ids if adapter is None else None
        pfx: dict = {}
        if sys_ids and len(ids_l) > len(sys_ids) \
                and ids_l[:len(sys_ids)] == sys_ids:
            # suffix admission length: spliced rows swap the one sentinel
            # for n_tokens soft tokens
            n_sfx = len(ids_l) - len(sys_ids)
            if sequence is not None:
                n_sfx += self.cfg.switch.n_tokens - 1
            if n_sfx <= self.engine.buckets[-1]:
                ids_l = ids_l[len(sys_ids):]
                pfx = {"prefix_id": "sys"}
        if sequence is not None:
            emb = self.run_on_engine(
                lambda: self._splice_ids(ids_l, sequence))
            n = emb.shape[0] + (len(sys_ids) if pfx else 0)
            return {"embeds": emb, "_prompt_tokens": n, **pfx}
        n = len(ids_l) + (len(sys_ids) if pfx else 0)
        return {"token_ids": np.asarray(ids_l, np.int32),
                "_prompt_tokens": n, **pfx}

    def warmup(self) -> None:
        """A no-op: the JAX server compiles its steps here; PyTorch runs
        eagerly."""

    def embed_items(self, items) -> tuple:
        """[("protein", sequence) | ("text", string)] -> (list of fp32
        shared-space vectors in input order, total token count).

        The stage-(a) retrieval surface as a serving feature: proteins run
        pooled-ESM -> CSTP protein projection, texts run the causal LM's
        (first + last hidden) mean -> CSTP text projection — both land in
        the same space (CSTPBase.forward, cstp_v3/modelling.py:378-394),
        so cosine(protein, text) ranks protein<->description matches.
        Lengths bucket-pad and batches pad to powers of two (padding rows
        repeat row 0), as in the JAX server. The model runs on the engine
        thread; the texts' LLM forward is an operation every rank of a
        lockstep server runs."""
        txt = [s for k, s in items if k == "text"]
        text_in = self._text_batch(txt) if txt else None
        wire = None if text_in is None else ("text_embed",) + text_in[:2]
        return self.run_on_engine(lambda: self._embed_items(items, text_in),
                                  wire=wire)

    def _text_batch(self, texts) -> tuple:
        """Texts -> (ids, mask, token count): bos-prefixed, right-padded to
        a bucket, the batch padded to a power of two by repeating row 0.
        Raises ValueError when this server cannot embed text."""
        if "cstp" not in self.params:
            raise ValueError("text embeddings need a CSTP adapter "
                             "(this server runs the identity-projector "
                             "fallback)")
        if self.cfg.cstp.text_dim != self.cfg.llm.hidden_size:
            raise ValueError(
                f"text embeddings are unavailable: the served LLM's "
                f"hidden size ({self.cfg.llm.hidden_size}) differs "
                f"from cstp.text_dim ({self.cfg.cstp.text_dim}) — the "
                "CSTP text encoder is a different model (stage-(a) "
                "training); protein embeddings still work")
        ids_l = []
        bos = getattr(self.tok, "bos_token_id", None)
        for s in texts:
            ids = list(self.tok.encode(s))
            if bos is not None and (not ids or ids[0] != bos):
                ids = [bos] + ids
            ids_l.append(ids)
        cap = round_up(max(len(i) for i in ids_l), self.prompt_bucket)
        ids, mask = pad_batch(ids_l, self.tok.pad_token_id, left=False,
                              max_len=cap)
        n = ServingEngine._pad_group(len(ids_l))
        ids = np.concatenate(
            [ids, np.repeat(ids[:1], n - len(ids_l), axis=0)])
        mask = np.concatenate(
            [mask, np.repeat(mask[:1], n - len(ids_l), axis=0)])
        return ids, mask, sum(len(i) for i in ids_l)

    @torch.no_grad()
    def _embed_items(self, items, text_in) -> tuple:
        dev = self.engine.device
        to = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        out: list = [None] * len(items)
        ntok = 0
        prot = [(i, s) for i, (k, s) in enumerate(items) if k == "protein"]
        txt = [(i, s) for i, (k, s) in enumerate(items) if k == "text"]
        if prot:
            seqs = [s for _, s in prot]
            toks, _ = esm2.tokenize(
                seqs, max_len=round_up(max(len(s) for s in seqs) + 2,
                                       self.esm_bucket))
            ntok += sum(len(s) + 2 for s in seqs)
            n = ServingEngine._pad_group(len(seqs))
            toks = np.concatenate(
                [toks, np.repeat(toks[:1], n - len(seqs), axis=0)])
            emb = opus.protein_cstp_embeddings(
                self.params, self.cfg, to(toks)).float().cpu().numpy()
            for (i, _), e in zip(prot, emb):
                out[i] = e
        if txt:
            ids, mask, n_text = text_in
            ntok += n_text
            emb = cstp_mod.text_forward(
                self.params["cstp"], _text_forward(self.engine, ids, mask)
            ).float().cpu().numpy()
            for (i, _), e in zip(txt, emb):
                out[i] = e
        return out, ntok

    def token_ids_generate(self, prompt: str) -> np.ndarray:
        ids = self.tok.encode(prompt)
        bos = getattr(self.tok, "bos_token_id", None)
        if bos is not None and (not ids or ids[0] != bos):
            ids = [bos] + list(ids)
        return np.asarray(ids, np.int32)

    # ------------------------------------------------------------------
    # engine thread
    # ------------------------------------------------------------------

    def _deliver(self, rid, result) -> None:
        """Hand a Completion (or the exception that doomed the request)
        to its waiting handler thread."""
        if rid in self._cancelled:     # requester is gone: drop, don't leak
            self._cancelled.discard(rid)
            return
        self._results[rid] = result
        ev = self._events.pop(rid, None)
        if ev is not None:
            ev.set()

    def _loop(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        try:
            self._iterate()
        except BaseException as e:   # noqa: BLE001 — lockstep faults only
            # a failed step or broadcast leaves the followers out of step:
            # every waiter fails, the loop ends, serve_forever raises
            self._fatal = e
            for rid in list(self._events):
                self._deliver(rid, LockstepError(
                    f"the tensor-parallel engine failed: "
                    f"{type(e).__name__}: {e}"))
            if self._on_fatal is not None:
                self._on_fatal()

    def _iterate(self) -> None:
        """The engine thread's loop: admin operations, cancellations and
        submissions, then a step when the engine is busy. Under lockstep
        each iteration's message goes to the followers before the
        collective work (module docstring)."""
        lock = self._lockstep
        while True:
            stop = self._stop.is_set()
            if stop and not lock:
                return
            msg = ({"ops": [], "cancels": [], "submits": [], "stop": stop}
                   if lock else None)
            later = []          # collective operations: after the message
            moved = False
            while True:
                try:
                    fn, done, box, wire = self._admin.get_nowait()
                except queue.Empty:
                    break
                moved = True
                if lock and wire is not None and wire[0] in _COLLECTIVE_OPS:
                    msg["ops"].append(wire)
                    later.append((fn, done, box))
                    continue
                try:
                    box["out"] = fn()
                    if lock and wire is not None:
                        msg["ops"].append(wire)
                except Exception as e:   # noqa: BLE001 — surfaces to the
                    box["err"] = e       # admin caller, not this thread
                done.set()
            while True:
                try:
                    rid = self._cancels.get_nowait()
                except queue.Empty:
                    break
                moved = True
                if lock:
                    msg["cancels"].append(rid)
                if self.engine.cancel(rid):
                    # its 'cancelled' Completion surfaces at the next
                    # harvest — mark it so _deliver drops it
                    self._cancelled.add(rid)
                elif rid in self._unsubmitted:
                    # the cancel outran the submission: mark it so the
                    # pending drain below drops the request instead of
                    # submitting a ghost with no waiter
                    self._cancelled.add(rid)
                self._events.pop(rid, None)
                self._results.pop(rid, None)
            while True:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                moved = True
                self._unsubmitted.discard(req.request_id)
                if req.request_id in self._cancelled:
                    self._cancelled.discard(req.request_id)
                    continue              # cancelled before submission
                try:
                    self.engine.submit(req)
                except Exception as e:   # invalid request: fail IT, not
                    self._deliver(req.request_id, e)  # the engine thread
                    continue
                if lock:
                    msg["submits"].append(_wire_request(req))
            busy = self.engine.busy
            if lock:
                msg["step"] = busy
                _broadcast(msg, self.mesh)
                for fn, done, box in later:
                    try:
                        box["out"] = fn()
                    except Exception as e:   # noqa: BLE001 — to the
                        box["err"] = e       # caller (a broken collective
                        # fails the next broadcast, which is fatal)
                    done.set()
                if stop:
                    return
            if busy:
                try:
                    for c in self.engine.step():
                        self._deliver(c.request_id, c)
                except Exception as e:
                    if lock:
                        raise
                    # an engine fault strands every in-flight request —
                    # fail them all loudly rather than hanging waiters
                    # (not the still-pending ones: those submit next
                    # iteration and succeed or get rejected there)
                    for rid in list(self._events):
                        if rid not in self._unsubmitted:
                            self._deliver(rid, e)
                moved = True
            if not moved:
                # idle: park until the next submission (or shutdown); a
                # lockstep server's next message leaves within 0.05 s
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def _check_admission(self) -> None:
        if self._draining:
            raise ServerDraining("server is draining; not accepting new "
                                 "requests")
        if self.max_queue is not None and self._queued() >= self.max_queue:
            raise ServerOverloaded(
                f"backlog at --max-queue ({self.max_queue}); retry with "
                "backoff")

    def submit_and_wait(self, *, embeds=None, token_ids=None,
                        max_new_tokens: int, temperature: float,
                        top_p: float = 1.0,
                        adapter: Optional[str] = None,
                        prefix_id=None,
                        timeout: Optional[float] = None) -> Completion:
        self._check_admission()
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        ev = threading.Event()
        self._events[rid] = ev
        self._unsubmitted.add(rid)   # before the put: the engine thread
        self._pending.put(ServeRequest(  # discards it on submission
            rid, embeds=embeds, token_ids=token_ids,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p,
            eos_token_id=self.tok.eos_token_id, adapter_id=adapter,
            prefix_id=prefix_id))
        self._wake.set()
        if not ev.wait(timeout):
            self._cancel(rid)
            raise TimeoutError(f"request {rid} timed out")
        out = self._results.pop(rid, None)
        if out is None:
            # the engine thread's cancel drain raced our wake-up and
            # popped the result — only the drain-timeout path does this
            raise ServerDraining("request cancelled by server drain")
        if isinstance(out, Exception):   # engine-side rejection
            raise out
        return out

    def submit_streaming(self, *, embeds=None, token_ids=None,
                         max_new_tokens: int, temperature: float,
                         top_p: float = 1.0,
                         adapter: Optional[str] = None,
                         prefix_id=None,
                         timeout: Optional[float] = None):
        """Generator of token-id delta lists; the Completion is the
        generator's return value (StopIteration.value). Deltas are pushed
        from the engine thread per decode tick, so the consumer sees
        tokens as they are produced; their concatenation equals
        Completion.tokens exactly (the engine never streams EOS).

        The draining/overload rejections happen EAGERLY at call time; the
        request itself enqueues lazily on first iteration (a generator
        that is never started must leave no trace — nothing to cancel)."""
        self._check_admission()
        return self._submit_streaming(
            embeds=embeds, token_ids=token_ids,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p, adapter=adapter, prefix_id=prefix_id,
            timeout=timeout)

    def _submit_streaming(self, *, embeds, token_ids, max_new_tokens,
                          temperature, top_p, adapter, prefix_id, timeout):
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        ev = threading.Event()
        self._events[rid] = ev
        q: "queue.Queue[list]" = queue.Queue()
        self._unsubmitted.add(rid)
        self._pending.put(ServeRequest(
            rid, embeds=embeds, token_ids=token_ids,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_p=top_p,
            eos_token_id=self.tok.eos_token_id, on_tokens=q.put,
            adapter_id=adapter, prefix_id=prefix_id))
        self._wake.set()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                try:
                    yield q.get(timeout=0.05)
                    continue
                except queue.Empty:
                    pass
                if ev.is_set():
                    # deltas are enqueued before the completion is
                    # delivered (same engine thread), so a final drain
                    # loses nothing
                    while True:
                        try:
                            yield q.get_nowait()
                        except queue.Empty:
                            break
                    break
                if deadline is not None and time.monotonic() > deadline:
                    self._cancel(rid)
                    raise TimeoutError(f"request {rid} timed out")
        except GeneratorExit:
            # consumer went away mid-stream (e.g. client disconnect):
            # free the slot instead of decoding to budget
            self._cancel(rid)
            raise
        out = self._results.pop(rid, None)
        if out is None:   # drain-timeout cancel raced the wake-up
            raise ServerDraining("request cancelled by server drain")
        if isinstance(out, Exception):
            raise out
        return out

    def _cancel(self, rid) -> None:
        """Route a cancellation through the engine thread (which owns all
        engine state) and wake it."""
        self._cancels.put(rid)
        self._wake.set()

    def run_on_engine(self, fn, timeout: float = 120.0, wire=None):
        """Execute fn() on the engine thread (which owns all engine
        state) and return its result; exceptions re-raise here. `wire`:
        the operation a lockstep server's followers replay (None: fn is
        this rank's alone)."""
        done = threading.Event()
        box: dict = {}
        self._admin.put((fn, done, box, wire))
        self._wake.set()
        if not done.wait(timeout):
            raise TimeoutError("engine admin operation timed out")
        if "err" in box:
            raise box["err"]
        return box.get("out")

    def _load_adapter_tree(self, path: str) -> dict:
        """A PEFT adapter directory -> its folded tree, read into CPU
        tensors on the calling thread (no CUDA call off the engine
        thread; `engine.add_adapter` copies it into the bank)."""
        from ..core import builder
        from ..lora.lora import fold_scaling
        tree, scale = builder.load_peft_adapter(path, self.cfg.llm.num_layers)
        return fold_scaling(tree, scale)

    def add_adapter(self, name: str, path: str) -> dict:
        """Load a PEFT adapter from disk and install it into a free bank
        row on the live engine — no recompile, no restart (the vLLM
        dynamic-LoRA-loading role). The disk load happens on the calling
        thread; only the in-place bank write runs on the engine thread."""
        tree = self._load_adapter_tree(path)
        self.run_on_engine(lambda: self.engine.add_adapter(name, tree),
                           wire=("add_adapter", name, tree))
        return self.adapters_info()

    def remove_adapter(self, name: str) -> dict:
        self.run_on_engine(lambda: self.engine.remove_adapter(name),
                           wire=("remove_adapter", name))
        return self.adapters_info()

    def adapters_info(self) -> dict:
        cap = self.engine.adapter_capacity
        names = sorted(self.engine.adapters)
        return {"adapters": names, "capacity": cap,
                "free": cap - len(names)}

    def begin_drain(self) -> None:
        """Stop accepting new requests: subsequent submits raise
        ServerDraining (HTTP 503, so load balancers retry elsewhere).
        In-flight requests keep decoding."""
        self._draining = True

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: reject new work, wait for every in-flight
        request to finish. After `timeout` seconds the stragglers are
        failed with ServerDraining (their waiters wake) and cancelled in
        the engine (slots freed). Returns True on a clean drain."""
        self.begin_drain()
        deadline = None if timeout is None else time.monotonic() + timeout
        while (self._events or not self._pending.empty()
               or self.engine.busy
               or np.any(self.engine.state["active"][:self.engine.max_slots])):
            if deadline is not None and time.monotonic() > deadline:
                for rid, ev in list(self._events.items()):
                    # a real completion racing in wins (setdefault);
                    # otherwise the waiter raises ServerDraining
                    self._results.setdefault(
                        rid, ServerDraining("request cancelled by server "
                                            "drain timeout"))
                    ev.set()
                    self._cancel(rid)    # free the slot / queue entry
                return False
            time.sleep(0.02)
        return True

    def close(self) -> None:
        """Stop the engine thread (under lockstep its last message stops
        the followers; the join then waits for it, each collective being
        bounded by the process group's timeout)."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=None if self._lockstep else 10)

    # ------------------------------------------------------------------
    # request handlers (shared by HTTP and tests)
    # ------------------------------------------------------------------

    @staticmethod
    def validate_sequence(sequence: str) -> None:
        """The REPL's amino-acid gate (run_opus_online.py contract)."""
        bad = set(sequence) - STANDARD_AA
        if bad:
            raise ValueError(
                f"invalid amino acids: {''.join(sorted(bad))} "
                f"(allowed: {''.join(sorted(STANDARD_AA))})")

    def handle_annotate(self, body: dict) -> dict:
        instruction = body.get("instruction", "").strip()
        sequence = body.get("sequence", "").strip().upper()
        if not instruction or not sequence:
            raise ValueError("'instruction' and 'sequence' are required")
        self.validate_sequence(sequence)
        sub = self.prepare_request(self._prompt_for(instruction), sequence,
                                   adapter=body.get("adapter"))
        sub.pop("_prompt_tokens")
        c = self.submit_and_wait(
            max_new_tokens=int(body.get("max_new_tokens",
                                        self.default_max_new)),
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            adapter=body.get("adapter"),
            timeout=body.get("_timeout"), **sub)
        text = truncate_at_sep(self.tok.decode(
            [t for t in c.tokens if t != self.tok.eos_token_id]))
        return {"text": text, "finish_reason": c.finish_reason,
                "tokens": len(c.tokens)}

    def handle_generate(self, body: dict) -> dict:
        prompt = body.get("prompt", "")
        if not prompt:
            raise ValueError("'prompt' is required")
        sub = self.prepare_request(prompt, None,
                                   adapter=body.get("adapter"))
        sub.pop("_prompt_tokens")
        c = self.submit_and_wait(
            max_new_tokens=int(body.get("max_new_tokens",
                                        self.default_max_new)),
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            adapter=body.get("adapter"),
            timeout=body.get("_timeout"), **sub)
        text = self.tok.decode(
            [t for t in c.tokens if t != self.tok.eos_token_id])
        return {"text": text, "finish_reason": c.finish_reason,
                "tokens": len(c.tokens)}

    def _stream_events(self, gen, *, truncate: bool):
        """Wrap a submit_streaming generator into SSE-able event dicts:
        one {"text": <new chars>, "token_ids": [...]} per delta (text via
        incremental re-decode, so BPE/byte merges across delta boundaries
        render correctly), then a final {"done": true, ...} carrying the
        post-processed full text (the '###' truncation is a whole-string
        rule, so it applies at the end, as the REPL does).

        Emitted text is strictly append-only (the OpenAI chunk contract:
        clients concatenate deltas): a multi-byte UTF-8 character split
        across byte-fallback BPE tokens decodes to a trailing U+FFFD,
        which is HELD BACK until later tokens complete it — never resent.
        Any held-back tail flushes as one last delta before the done
        event, so delta concatenation still equals the full decode."""
        toks: list = []
        sent = ""
        gi = iter(gen)
        try:
            while True:
                try:
                    delta = next(gi)
                except StopIteration as s:
                    c = s.value
                    full = self.tok.decode(toks)
                    if full.startswith(sent):
                        flush = full[len(sent):]
                    else:   # mid-stream rewrite (shouldn't occur given the
                        # U+FFFD hold-back): resend only past the longest
                        # common prefix, never the whole string
                        n = next((i for i, (a, b) in enumerate(zip(sent,
                                                                   full))
                                  if a != b), min(len(sent), len(full)))
                        flush = full[n:]
                    if flush:
                        yield {"text": flush, "token_ids": []}
                    if truncate:
                        full = truncate_at_sep(full)
                    yield {"done": True, "text": full,
                           "finish_reason": c.finish_reason,
                           "tokens": len(toks)}
                    return
                toks.extend(delta)
                stable = self.tok.decode(toks)
                while stable.endswith("�"):   # incomplete UTF-8 tail
                    stable = stable[:-1]
                if stable.startswith(sent):
                    new, sent = stable[len(sent):], stable
                else:   # rewrite beyond the held-back tail (rare): hold
                    new = ""  # everything back; the final flush reconciles
                yield {"text": new, "token_ids": list(delta)}
        finally:
            gi.close()   # closing us cancels the underlying request

    def stream_annotate(self, body: dict):
        instruction = body.get("instruction", "").strip()
        sequence = body.get("sequence", "").strip().upper()
        if not instruction or not sequence:
            raise ValueError("'instruction' and 'sequence' are required")
        self.validate_sequence(sequence)
        sub = self.prepare_request(self._prompt_for(instruction), sequence,
                                   adapter=body.get("adapter"))
        sub.pop("_prompt_tokens")
        gen = self.submit_streaming(
            max_new_tokens=int(body.get("max_new_tokens",
                                        self.default_max_new)),
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            adapter=body.get("adapter"),
            timeout=body.get("_timeout"), **sub)
        return self._stream_events(gen, truncate=True)

    def stream_generate(self, body: dict):
        prompt = body.get("prompt", "")
        if not prompt:
            raise ValueError("'prompt' is required")
        sub = self.prepare_request(prompt, None,
                                   adapter=body.get("adapter"))
        sub.pop("_prompt_tokens")
        gen = self.submit_streaming(
            max_new_tokens=int(body.get("max_new_tokens",
                                        self.default_max_new)),
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            adapter=body.get("adapter"),
            timeout=body.get("_timeout"), **sub)
        return self._stream_events(gen, truncate=False)

    def _queued(self) -> int:
        """Real backlog: requests waiting for a slot (engine queue +
        mid-chunked-prefill) plus the thread-handoff queue, which drains
        every loop iteration and reads ~0 under load on its own. Read
        cross-thread without locking, like the counters — momentarily
        stale is fine for a gauge."""
        return (len(self.engine._queue) + len(self.engine._chunking)
                + self._pending.qsize())

    def health(self) -> dict:
        return {"status": "draining" if self._draining else "ok",
                "slots": self.engine.max_slots,
                "active": int(np.sum(self.engine.state["active"])),
                "queued": self._queued(),
                **{f"total_{k}": v
                   for k, v in self.engine.counters.items()},
                **{f"{k}_mean_s": round(h.mean, 6)
                   for k, h in self.engine.latency.items()}}

    def metrics_text(self) -> str:
        """GET /metrics: Prometheus text exposition of the engine counters
        and gauges, so the daemon drops into standard scrape-based
        monitoring without an adapter."""
        c = self.engine.counters
        lines = [
            "# TYPE opus_serve_completions_total counter",
            f"opus_serve_completions_total {c['completions']}",
            "# TYPE opus_serve_tokens_total counter",
            f"opus_serve_tokens_total {c['tokens']}",
            "# TYPE opus_serve_prefills_total counter",
            f"opus_serve_prefills_total {c['prefills']}",
            "# TYPE opus_serve_cancelled_total counter",
            f"opus_serve_cancelled_total {c['cancelled']}",
            "# TYPE opus_serve_ticks_total counter",
            f"opus_serve_ticks_total {self.engine._tick}",
            "# TYPE opus_serve_slots gauge",
            f"opus_serve_slots {self.engine.max_slots}",
            "# TYPE opus_serve_active_slots gauge",
            f"opus_serve_active_slots "
            f"{int(np.sum(self.engine.state['active']))}",
            "# TYPE opus_serve_queued_requests gauge",
            f"opus_serve_queued_requests {self._queued()}",
        ]
        # request-latency histograms (queue wait / TTFT / duration),
        # observed at the engine so they cover every front (HTTP + eval)
        for k, h in self.engine.latency.items():
            lines.extend(h.prometheus(f"opus_serve_{k}_seconds"))
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------
    # HTTP
    # ------------------------------------------------------------------

    def make_http_server(self, host: str, port: int) -> ThreadingHTTPServer:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, payload: dict) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):            # noqa: N802 (http.server API)
                if self.path == "/health":
                    self._send(200, outer.health())
                elif self.path == "/v1/models":
                    from . import openai_api
                    self._send(200, openai_api.list_models(outer))
                elif self.path == "/v1/adapters":
                    self._send(200, outer.adapters_info())
                elif self.path == "/metrics":
                    data = outer.metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._send(404, {"error": "unknown path"})

            def do_DELETE(self):         # noqa: N802
                if self.path.startswith("/v1/adapters/"):
                    name = self.path[len("/v1/adapters/"):]
                    try:
                        self._send(200, outer.remove_adapter(name))
                    except ValueError as e:
                        self._send(400, {"error": str(e)})
                    except Exception as e:   # noqa: BLE001
                        self._send(500, {"error":
                                         f"{type(e).__name__}: {e}"})
                else:
                    self._send(404, {"error": "unknown path"})

            def _send_sse(self, events) -> None:
                """Server-sent events; HTTP/1.0 connection-close framing
                (no Content-Length), flushed per event so clients see
                tokens as the engine produces them."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                try:
                    for ev in events:
                        # a raw string event frames verbatim — the OpenAI
                        # stream terminator `data: [DONE]`
                        data = (ev.encode() if isinstance(ev, str)
                                else json.dumps(ev).encode())
                        try:
                            self.wfile.write(b"data: " + data + b"\n\n")
                            self.wfile.flush()
                        except OSError:   # client disconnected: closing
                            return        # the generator cancels decoding
                except Exception as e:   # noqa: BLE001 — producer fault
                    try:
                        self.wfile.write(
                            b"data: " + json.dumps(
                                {"error":
                                 f"{type(e).__name__}: {e}"}).encode()
                            + b"\n\n")
                    except OSError:
                        pass
                finally:
                    events.close()

            def do_POST(self):           # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                # OpenAI endpoints use OpenAI's nested error shape
                oai = self.path in ("/v1/chat/completions",
                                    "/v1/completions", "/v1/embeddings")
                err = ((lambda m, t: {"error": {"message": m, "type": t}})
                       if oai else (lambda m, t: {"error": m}))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                    stream = bool(body.get("stream"))
                    if self.path == "/v1/annotate":
                        if stream:
                            self._send_sse(outer.stream_annotate(body))
                        else:
                            self._send(200, outer.handle_annotate(body))
                    elif self.path == "/v1/generate":
                        if stream:
                            self._send_sse(outer.stream_generate(body))
                        else:
                            self._send(200, outer.handle_generate(body))
                    elif self.path == "/v1/chat/completions":
                        from . import openai_api
                        if stream:
                            self._send_sse(openai_api.stream_chat(
                                outer, body))
                        else:
                            self._send(200, openai_api.handle_chat(
                                outer, body))
                    elif self.path == "/v1/completions":
                        from . import openai_api
                        if stream:
                            self._send_sse(openai_api.stream_completion(
                                outer, body))
                        else:
                            self._send(200, openai_api.handle_completion(
                                outer, body))
                    elif self.path == "/v1/embeddings":
                        from . import openai_api
                        self._send(200, openai_api.handle_embeddings(
                            outer, body))
                    elif self.path == "/v1/adapters":
                        name = body.get("name", "")
                        path = body.get("path", "")
                        if not name or not path:
                            raise ValueError("'name' and 'path' are "
                                             "required")
                        self._send(200, outer.add_adapter(name, path))
                    else:
                        self._send(404, err("unknown path",
                                            "invalid_request_error"))
                except ServerDraining as e:
                    self._send(503, err(str(e), "server_draining"))
                except ServerOverloaded as e:
                    self._send(429, err(str(e), "server_overloaded"))
                except (ValueError, KeyError) as e:
                    self._send(400, err(str(e), "invalid_request_error"))
                except TimeoutError as e:
                    self._send(504, err(str(e), "timeout_error"))
                except Exception as e:   # noqa: BLE001 — HTTP boundary
                    self._send(500, err(f"{type(e).__name__}: {e}",
                                        "internal_error"))

            def log_message(self, fmt, *args):   # quiet access log
                pass

        return ThreadingHTTPServer((host, port), Handler)

    def serve_forever(self, host: str = "0.0.0.0", port: int = 8000, *,
                      drain_grace: float = 30.0) -> None:
        httpd = self.make_http_server(host, port)
        print(f"opus-pllm serving on http://{host}:{port} "
              f"({self.engine.max_slots} slots, cap {self.engine.max_len})")

        def _term(signum, frame):
            # SIGTERM (the orchestrator's stop signal): reject new work
            # with 503, let in-flight requests finish up to drain_grace
            # seconds, then stop the HTTP loop. Runs on a thread because
            # httpd.shutdown() deadlocks from the serve_forever thread.
            print(f"SIGTERM: draining (grace {drain_grace:.0f}s)...")
            threading.Thread(
                target=lambda: (self.drain(drain_grace), httpd.shutdown()),
                daemon=True).start()

        import signal
        try:
            signal.signal(signal.SIGTERM, _term)
        except ValueError:
            pass   # not the main thread (embedded/test use)
        # a lockstep fault stops the HTTP loop; serve_forever then raises
        self._on_fatal = lambda: threading.Thread(target=httpd.shutdown,
                                                  daemon=True).start()
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()
            self.close()
        if self._fatal is not None:
            raise LockstepError("the tensor-parallel server stopped") \
                from self._fatal
