"""OpenAI-compatible API over the serving daemon (port of
`opus_pllm_tpu/serve/openai_api.py`, all of it).

`/v1/chat/completions`, `/v1/completions`, `/v1/embeddings` and
`/v1/models` on the same `serve.server.OpusServer` that hosts the native
/v1/annotate front, so an OpenAI client drives the continuous-batching
engine without glue.

Conventions (vLLM's multi-LoRA serving):
  - `model` routes adapters: the served model name selects the base
    weights, a bank adapter's name that adapter, inside the same tick.
  - protein input rides the chat content-parts convention: a message
    content list may carry one {"type": "protein", "sequence": "MKT..."}
    part; it renders as the <seq> splice marker in the prompt.
  - streaming is SSE chat chunks terminated by `data: [DONE]`.

Engine limits are 400s: n > 1 and logprobs are refused. temperature and
top_p apply per request inside the tick (`sample_token_rows`). `stop`
strings truncate the blocking paths after the fact and are scanned
append-only on the streaming paths (`_stop_filter`: a held-back tail so a
stop split across deltas matches; a match cancels the engine request).
Handlers are plain Python over the server's methods and touch no tensor.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ..infer.conversation import VICUNA_V0

_FINISH = {"eos": "stop", "length": "length"}


def _check_unsupported(body: dict) -> None:
    tp = float(body.get("top_p", 1.0))
    if not 0.0 < tp <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {tp}")
    if int(body.get("n", 1)) != 1:
        raise ValueError("n>1 is unsupported; send parallel requests "
                         "instead (they batch in the engine)")
    if body.get("logprobs") or body.get("top_logprobs"):
        raise ValueError("logprobs are unsupported")


def _stops(body: dict) -> List[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    stops = [stop] if isinstance(stop, str) else list(stop)
    if any(not isinstance(s, str) or not s for s in stops):
        # an empty stop matches at position 0 and would terminate every
        # completion with zero output; OpenAI 400s it too
        raise ValueError("stop strings must be non-empty strings")
    return stops


def _truncate_at(text: str, stops: List[str]) -> Tuple[str, bool]:
    cut = len(text)
    for s in stops:
        i = text.find(s)
        if i != -1:
            cut = min(cut, i)
    return text[:cut], cut < len(text)


def _max_new(srv, body: dict) -> int:
    # chat endpoints deprecate max_tokens for max_completion_tokens;
    # accept both, newer name wins; an explicit invalid value (0, -3) is
    # a 400 like other bad params, not a silent fall-through
    for key in ("max_completion_tokens", "max_tokens"):
        v = body.get(key)
        if v is not None:
            v = int(v)
            if v < 1:
                raise ValueError(f"{key} must be >= 1, got {v}")
            return v
    return srv.default_max_new


def resolve_model(srv, body: dict) -> Optional[str]:
    """OpenAI `model` -> engine adapter_id (None = base weights). The
    served model name (or an absent field) selects the base; a bank
    adapter name selects that adapter."""
    name = body.get("model")
    if name in (None, "", srv.model_id):
        return None
    if name in srv.engine.adapters:
        return name
    known = [srv.model_id, *srv.engine.adapters]
    raise ValueError(f"model {name!r} not found (serving: {known})")


def _split_parts(content) -> Tuple[str, Optional[str]]:
    """OpenAI content (str | list of parts) -> (text, protein sequence).
    A {"type": "protein", "sequence": ...} part marks where the spliced
    protein goes (rendered as the <seq> marker)."""
    if isinstance(content, str):
        return content, None
    texts, seq = [], None
    for part in content:
        t = part.get("type")
        if t == "text":
            texts.append(part.get("text", ""))
        elif t == "protein":
            if seq is not None:
                raise ValueError("at most one protein part per request")
            seq = part.get("sequence", "").strip().upper()
            texts.append("<seq>")
        else:
            raise ValueError(f"unsupported content part type {t!r} "
                             "(text, protein)")
    return "\n".join(texts), seq


def chat_prompt(srv, messages: List[dict]) -> Tuple[str, Optional[str]]:
    """messages -> (decoder prompt, optional protein sequence).

    Chat-template models (cli serve --chat-template) render through the
    tokenizer's own template, exactly like the Evol chat runner; otherwise
    the professor conversation preset assembles the turns (the same
    get_prompt layout as the reference's REPL, conversation.py)."""
    if not messages:
        raise ValueError("'messages' is required")
    seq: Optional[str] = None
    flat = []
    for m in messages:
        role = m.get("role")
        if role not in ("system", "user", "assistant"):
            raise ValueError(f"unsupported role {role!r}")
        text, s = _split_parts(m.get("content") or "")
        if s is not None:
            if seq is not None:
                raise ValueError("at most one protein part per request")
            seq = s
        flat.append({"role": role, "content": text})
    if srv.chat_template:
        return srv.tok.apply_chat_template(
            flat, add_generation_prompt=True), seq
    # the REPL's manual layout (annotation_prompt / run_opus_ddp.py:102-107),
    # extended over turns — a single user message renders byte-identically
    # to the native /v1/annotate prompt
    system = [m["content"] for m in flat if m["role"] == "system"]
    roles = {"user": VICUNA_V0.roles[0], "assistant": VICUNA_V0.roles[1]}
    out = [(system[-1] if system else VICUNA_V0.system) + "\n\n"]
    for m in flat:
        if m["role"] != "system":
            out.append(f"### {roles[m['role']]}: {m['content']}\n")
    out.append(f"### {VICUNA_V0.roles[1]}:")
    return "".join(out), seq


def _submit_args(srv, prompt: str, seq: Optional[str],
                 adapter: Optional[str] = None) -> Dict[str, Any]:
    """Route multimodal prompts through the splice front, text-only ones
    through plain token ids — both via prepare_request, which takes the
    pinned system-prefix path when it applies. Returns submit kwargs +
    prompt token count."""
    if seq is not None:
        if not seq:
            raise ValueError("protein part has an empty 'sequence'")
        srv.validate_sequence(seq)
    return srv.prepare_request(prompt, seq, adapter=adapter)


def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def handle_chat(srv, body: dict) -> dict:
    _check_unsupported(body)
    adapter = resolve_model(srv, body)
    prompt, seq = chat_prompt(srv, body.get("messages") or [])
    sub = _submit_args(srv, prompt, seq, adapter)
    ptoks = sub.pop("_prompt_tokens")
    c = srv.submit_and_wait(
        max_new_tokens=_max_new(srv, body),
        temperature=float(body.get("temperature", 0.0)),
        top_p=float(body.get("top_p", 1.0)),
        adapter=adapter, timeout=body.get("_timeout"), **sub)
    text = srv.tok.decode(
        [t for t in c.tokens if t != srv.tok.eos_token_id])
    text, stopped = _truncate_at(text, _stops(body))
    return {
        "id": f"chatcmpl-{c.request_id}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": body.get("model") or srv.model_id,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": ("stop" if stopped
                              else _FINISH.get(c.finish_reason,
                                               c.finish_reason)),
        }],
        "usage": _usage(ptoks, len(c.tokens)),
    }


def handle_completion(srv, body: dict) -> dict:
    _check_unsupported(body)
    adapter = resolve_model(srv, body)
    prompt = body.get("prompt")
    if isinstance(prompt, list):
        if len(prompt) != 1:
            raise ValueError("batch prompts are unsupported; send "
                             "parallel requests (they batch in the engine)")
        prompt = prompt[0]
    if not isinstance(prompt, str) or not prompt:
        raise ValueError("'prompt' (non-empty string) is required")
    if body.get("echo"):
        raise ValueError("echo is unsupported")
    sub = _submit_args(srv, prompt, None, adapter)
    ptoks = sub.pop("_prompt_tokens")
    c = srv.submit_and_wait(
        max_new_tokens=_max_new(srv, body),
        temperature=float(body.get("temperature", 0.0)),
        top_p=float(body.get("top_p", 1.0)),
        adapter=adapter, timeout=body.get("_timeout"), **sub)
    text = srv.tok.decode(
        [t for t in c.tokens if t != srv.tok.eos_token_id])
    text, stopped = _truncate_at(text, _stops(body))
    return {
        "id": f"cmpl-{c.request_id}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": body.get("model") or srv.model_id,
        "choices": [{
            "index": 0,
            "text": text,
            "finish_reason": ("stop" if stopped
                              else _FINISH.get(c.finish_reason,
                                               c.finish_reason)),
        }],
        "usage": _usage(ptoks, len(c.tokens)),
    }


def _stop_filter(events, stops: List[str]):
    """Append-only stop-string scan over a _stream_events stream.

    Emitted text is held back by max(len(stop)) - 1 chars so a stop
    string split across deltas still matches. On a match: the text
    before the stop flushes, the underlying stream closes (which cancels
    the engine request — no budget wasted past the stop), and a
    synthetic done event with finish_reason "stop" ends the stream.
    Without a match the held-back tail flushes before the real done."""
    hold = max(len(s) for s in stops) - 1
    pend = ""                      # received but not yet emitted
    try:
        for ev in events:
            if ev.get("done"):
                if pend:
                    yield {"text": pend, "token_ids": []}
                yield ev
                return
            pend += ev.get("text", "")
            cut = min((i for i in (pend.find(s) for s in stops)
                       if i != -1), default=-1)
            if cut != -1:
                if pend[:cut]:
                    yield {"text": pend[:cut], "token_ids": []}
                yield {"done": True, "text": "", "finish_reason": "stop",
                       "tokens": 0}
                return
            safe = len(pend) - hold
            if safe > 0:
                yield {"text": pend[:safe], "token_ids": []}
                pend = pend[safe:]
    finally:
        events.close()   # on a stop match / consumer exit: cancel decode


def stream_chat(srv, body: dict):
    """SSE generator of chat.completion.chunk payloads. The HTTP layer
    frames each yielded dict as `data: <json>`; the final yield is the
    literal string "[DONE]" (OpenAI's terminator)."""
    _check_unsupported(body)
    adapter = resolve_model(srv, body)
    prompt, seq = chat_prompt(srv, body.get("messages") or [])
    sub = _submit_args(srv, prompt, seq, adapter)
    sub.pop("_prompt_tokens")
    gen = srv.submit_streaming(
        max_new_tokens=_max_new(srv, body),
        temperature=float(body.get("temperature", 0.0)),
        top_p=float(body.get("top_p", 1.0)),
        adapter=adapter, timeout=body.get("_timeout"), **sub)
    cid = f"chatcmpl-{int(time.time() * 1000)}"
    model = body.get("model") or srv.model_id

    def chunk(delta: dict, finish: Optional[str]) -> dict:
        return {"id": cid, "object": "chat.completion.chunk",
                "created": int(time.time()), "model": model,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}]}

    stream = srv._stream_events(gen, truncate=False)
    if _stops(body):
        stream = _stop_filter(stream, _stops(body))

    def events():
        yield chunk({"role": "assistant", "content": ""}, None)
        finish = "stop"
        for ev in stream:
            if ev.get("done"):
                finish = _FINISH.get(ev["finish_reason"],
                                     ev["finish_reason"])
                break
            if ev.get("text"):
                yield chunk({"content": ev["text"]}, None)
        yield chunk({}, finish)
        yield "[DONE]"

    return events()


def stream_completion(srv, body: dict):
    """SSE generator of text_completion chunks, `data: [DONE]`-terminated."""
    _check_unsupported(body)
    adapter = resolve_model(srv, body)
    prompt = body.get("prompt")
    if isinstance(prompt, list):
        if len(prompt) != 1:
            raise ValueError("batch prompts are unsupported; send "
                             "parallel requests (they batch in the engine)")
        prompt = prompt[0]
    if not isinstance(prompt, str) or not prompt:
        raise ValueError("'prompt' (non-empty string) is required")
    sub = _submit_args(srv, prompt, None, adapter)
    sub.pop("_prompt_tokens")
    gen = srv.submit_streaming(
        max_new_tokens=_max_new(srv, body),
        temperature=float(body.get("temperature", 0.0)),
        top_p=float(body.get("top_p", 1.0)),
        adapter=adapter, timeout=body.get("_timeout"), **sub)
    cid = f"cmpl-{int(time.time() * 1000)}"
    model = body.get("model") or srv.model_id

    def chunk(text: str, finish: Optional[str]) -> dict:
        return {"id": cid, "object": "text_completion",
                "created": int(time.time()), "model": model,
                "choices": [{"index": 0, "text": text,
                             "finish_reason": finish}]}

    stream = srv._stream_events(gen, truncate=False)
    if _stops(body):
        stream = _stop_filter(stream, _stops(body))

    def events():
        finish = "stop"
        for ev in stream:
            if ev.get("done"):
                finish = _FINISH.get(ev["finish_reason"],
                                     ev["finish_reason"])
                break
            if ev.get("text"):
                yield chunk(ev["text"], None)
        yield chunk("", finish)
        yield "[DONE]"

    return events()


def handle_embeddings(srv, body: dict) -> dict:
    """POST /v1/embeddings: OpenAI envelope over the CSTP shared space.

    `input` is a string, a {"type": "protein", "sequence": ...} part, or a
    list mixing both — proteins embed via pooled-ESM -> CSTP protein
    projection, plain strings via the text-encoder mean -> CSTP text
    projection (same space, so cosine ranks protein<->text matches; the
    stage-(a) retrieval capability as an API)."""
    name = body.get("model")
    if name not in (None, "", srv.model_id):
        raise ValueError(f"model {name!r} not found (embeddings serve "
                         f"{srv.model_id!r}; adapters don't apply)")
    if body.get("encoding_format", "float") != "float":
        raise ValueError("only encoding_format='float' is supported")
    raw = body.get("input")
    if raw is None:
        raise ValueError("'input' is required")
    if isinstance(raw, (str, dict)):
        raw = [raw]
    if not raw:
        raise ValueError("'input' must not be empty")
    items = []
    for it in raw:
        if isinstance(it, str):
            if not it:
                raise ValueError("empty string in 'input'")
            items.append(("text", it))
        elif isinstance(it, dict) and it.get("type") == "protein":
            seq = it.get("sequence", "").strip().upper()
            if not seq:
                raise ValueError("protein part has an empty 'sequence'")
            srv.validate_sequence(seq)
            items.append(("protein", seq))
        else:
            raise ValueError("input entries must be strings or "
                             '{"type": "protein", "sequence": ...} parts')
    embs, ntok = srv.embed_items(items)
    return {
        "object": "list",
        "data": [{"object": "embedding", "index": i,
                  "embedding": e.tolist()}
                 for i, e in enumerate(embs)],
        "model": body.get("model") or srv.model_id,
        "usage": {"prompt_tokens": ntok, "total_tokens": ntok},
    }


def list_models(srv) -> dict:
    """GET /v1/models: the served base + every bank adapter (each is a
    routable `model` name)."""
    now = int(time.time())
    row = lambda name, root: {"id": name, "object": "model",  # noqa: E731
                              "created": now, "owned_by": "opus-pllm-tpu",
                              "root": root}
    return {"object": "list",
            "data": [row(srv.model_id, srv.model_id)] +
                    [row(a, srv.model_id) for a in srv.engine.adapters]}
