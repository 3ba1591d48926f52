"""aiohttp application: OpenAI-compatible endpoints over the port's
engines.

Port of the JAX package's ``pie_tpu/server/app.py``: the same handlers,
wire schemas and error mapping. Engine calls run in worker threads: behind
a lock for the single-stream ``InferenceEngine``, without one for the
continuous-batching ``BatchedInferenceEngine``, which decodes concurrent
requests (and the choices of an ``n > 1`` chat) as lanes of one batch.
Without an engine, ``create_app`` builds one from the checkpoint that
MODEL_PATH names (``python -m pie_tpu_torch.server``), batching when
BATCHING=1.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import threading
from typing import Any, Optional

from aiohttp import web

from pie_tpu_torch.engine.async_engine import BatchedInferenceEngine
from pie_tpu_torch.engine.engine import InferenceEngine, InferenceError
from pie_tpu_torch.server import schemas as S
from pie_tpu_torch.server.config import Settings, get_settings
from pie_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

ENGINE_KEY = web.AppKey("engine", object)
LOCK_KEY = web.AppKey("engine_lock", asyncio.Lock)


def _err(status: int, message: str, etype: str = "invalid_request_error"):
    return web.json_response(
        S.ErrorResponse(error=S.ErrorBody(message=message, type=etype)).model_dump(),
        status=status,
    )


def _gen_kwargs(req) -> dict[str, Any]:
    """Map wire params -> engine kwargs (reference chat.py:60-77)."""
    kw: dict[str, Any] = {}
    if req.temperature is not None:
        kw["temperature"] = req.temperature
    if req.top_p is not None:
        kw["top_p"] = req.top_p
    if getattr(req, "top_k", None) is not None:
        kw["top_k"] = req.top_k
    if getattr(req, "min_p", None) is not None:
        kw["min_p"] = req.min_p
    if getattr(req, "presence_penalty", None):
        kw["presence_penalty"] = req.presence_penalty
    if getattr(req, "frequency_penalty", None):
        kw["frequency_penalty"] = req.frequency_penalty
    if getattr(req, "repetition_penalty", None):
        kw["repetition_penalty"] = req.repetition_penalty
    # non-standard extensions the reference stubbed (samplers/xtc.py,
    # samplers/dry.py are 0-byte placeholders there)
    if getattr(req, "xtc_probability", None):
        kw["xtc_probability"] = req.xtc_probability
    if getattr(req, "xtc_threshold", None) is not None:
        kw["xtc_threshold"] = req.xtc_threshold
    if getattr(req, "dry_multiplier", None):
        kw["dry_multiplier"] = req.dry_multiplier
    if getattr(req, "dry_base", None) is not None:
        kw["dry_base"] = req.dry_base
    if getattr(req, "dry_allowed_length", None) is not None:
        kw["dry_allowed_length"] = req.dry_allowed_length
    if getattr(req, "logit_bias", None):
        kw["logit_bias"] = {int(k): v for k, v in req.logit_bias.items()}
    return kw


async def _run_blocking(app, fn, *args, **kwargs):
    # the single-stream engine runs one call at a time under the lock, in
    # a worker thread: its prefill and decode-step captures
    # (engine/graphs.py) happen there while no other thread drives the
    # engine
    async with app[LOCK_KEY]:
        return await asyncio.get_event_loop().run_in_executor(
            None, lambda: fn(*args, **kwargs)
        )


# -- chat -------------------------------------------------------------------


async def handle_chat(request: web.Request) -> web.StreamResponse:
    app = request.app
    engine: InferenceEngine = app[ENGINE_KEY]
    try:
        req = S.ChatCompletionRequest.model_validate(await request.json())
    except Exception as e:
        return _err(422, f"invalid request: {e}")
    n_choices = max(1, req.n or 1)
    if n_choices > 1 and (req.stream or not isinstance(engine, BatchedInferenceEngine)):
        # the single-stream engine and streaming degrade to one choice; the
        # batching engine decodes the choices as concurrent lanes
        n_choices = 1
    kw = _gen_kwargs(req)
    max_tokens = req.max_completion_tokens or req.max_tokens or 1024
    tools = [t.model_dump() for t in req.tools] if req.tools else None
    tool_choice = req.tool_choice
    if isinstance(tool_choice, S.NamedToolChoice):
        tool_choice = tool_choice.model_dump()
    if tool_choice == "none":
        tools = None
        tool_choice = "auto"
    interactions = [
        {
            "role": "user" if m.role == "developer" else m.role,
            "text": m.text(),
            "images": m.images(),
        }
        for m in req.messages
    ]
    response_format = (
        req.response_format.model_dump() if req.response_format else None
    )

    if not req.stream:
        from pie_tpu_torch.utils.metrics import Timer, get_metrics

        timer = Timer()
        chat_kwargs = dict(
            tools=tools, response_format=response_format,
            tool_choice=tool_choice or "auto",
            parallel_tool_calls=bool(req.parallel_tool_calls),
            stop=req.stop, max_completion_tokens=max_tokens,
            logprobs=bool(req.logprobs), reasoning=bool(req.reasoning),
            **kw,
        )

        try:
            inters = await _chat_choices(app, engine, interactions, chat_kwargs,
                                         n_choices)
        except (InferenceError, ValueError) as e:
            get_metrics().record_request(0, 0, None, timer.elapsed, error=True)
            return _err(400, str(e))
        pt = inters[0].prompt_tokens
        ct = sum(i.completion_tokens for i in inters)
        get_metrics().record_request(pt, ct, None, timer.elapsed)
        resp = _chat_response(engine, req, inters[0])
        for idx, inter in enumerate(inters[1:], start=1):
            choice = _chat_response(engine, req, inter).choices[0]
            choice.index = idx
            resp.choices.append(choice)
        if len(inters) > 1:
            resp.usage = S.Usage(prompt_tokens=pt, completion_tokens=ct,
                                 total_tokens=pt + ct)
        return web.json_response(resp.model_dump(exclude_none=True))

    # -- SSE streaming (reference chat.py:160-249) --
    resp = web.StreamResponse(
        status=200,
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        },
    )
    await resp.prepare(request)
    chat_id = S._id("chatcmpl")

    async def send(obj):
        await resp.write(f"data: {json.dumps(obj)}\n\n".encode())

    # role-first chunk
    await send(
        S.ChatCompletionChunk(
            id=chat_id, model=req.model,
            choices=[S.ChunkChoice(delta=S.ChunkDelta(role="assistant"))],
        ).model_dump(exclude_none=True)
    )

    loop = asyncio.get_event_loop()
    queue: asyncio.Queue = asyncio.Queue()
    # set when the response ends early (the client went away): the
    # producer closes the generation at its next token
    abandoned = threading.Event()

    def producer():
        try:
            gen = engine.chat_stream(
                interactions, tools=tools, response_format=response_format,
                tool_choice=tool_choice or "auto",
                parallel_tool_calls=bool(req.parallel_tool_calls),
                stop=req.stop, max_completion_tokens=max_tokens,
                logprobs=bool(req.logprobs),
                reasoning=bool(req.reasoning), **kw,
            )
            while True:
                if abandoned.is_set():
                    gen.close()
                    return
                try:
                    delta = next(gen)
                    loop.call_soon_threadsafe(queue.put_nowait, ("delta", delta))
                except StopIteration as e:
                    loop.call_soon_threadsafe(queue.put_nowait, ("done", e.value))
                    return
        except Exception as e:  # pragma: no cover
            loop.call_soon_threadsafe(queue.put_nowait, ("error", e))

    async with app[LOCK_KEY]:
        fut = loop.run_in_executor(None, producer)
        inter = None
        try:
            while True:
                kind, payload = await queue.get()
                if kind == "delta":
                    if payload.text:
                        await send(
                            S.ChatCompletionChunk(
                                id=chat_id, model=req.model,
                                choices=[S.ChunkChoice(
                                    delta=S.ChunkDelta(content=payload.text)
                                )],
                            ).model_dump(exclude_none=True)
                        )
                elif kind == "done":
                    inter = payload
                    break
                else:
                    await send({"error": {"message": str(payload)}})
                    break
        finally:
            # the lock is held until the engine is idle: a write that fails
            # (the client went away) must not let the next request drive
            # the engine, and capture its graphs, while this generation
            # still replays them in the producer's thread
            abandoned.set()
            await fut

    if inter is not None:
        final = S.ChatCompletionChunk(
            id=chat_id, model=req.model,
            choices=[S.ChunkChoice(
                delta=S.ChunkDelta(), finish_reason=inter.finish_reason
            )],
        )
        await send(final.model_dump(exclude_none=True))
        if req.stream_options and req.stream_options.include_usage:
            usage = S.Usage(
                prompt_tokens=inter.prompt_tokens,
                completion_tokens=inter.completion_tokens,
                total_tokens=inter.prompt_tokens + inter.completion_tokens,
            )
            await send(
                S.ChatCompletionChunk(
                    id=chat_id, model=req.model, choices=[], usage=usage
                ).model_dump(exclude_none=True)
            )
    await resp.write(b"data: [DONE]\n\n")
    await resp.write_eof()
    return resp


async def _chat_choices(app, engine, interactions, chat_kwargs, n_choices):
    """The assistant turns of one chat request: one, or ``n_choices``
    decoded as concurrent lanes of the batching engine. When one choice
    fails, its siblings are cancelled instead of decoding on."""
    if n_choices == 1:
        return [await _run_blocking(app, engine.chat, interactions, **chat_kwargs)]
    cancel_evt = threading.Event()

    def one_choice():
        gen = engine.chat_stream(interactions, **chat_kwargs)
        try:
            while True:
                if cancel_evt.is_set():
                    gen.close()  # cancels the sequence
                    raise InferenceError("cancelled: sibling choice failed")
                next(gen)
        except StopIteration as e:
            return e.value

    tasks = [asyncio.ensure_future(_run_blocking(app, one_choice))
             for _ in range(n_choices)]
    done, pending = await asyncio.wait(tasks, return_when=asyncio.FIRST_EXCEPTION)
    first_err = next((t.exception() for t in done if t.exception()), None)
    if first_err is not None:
        cancel_evt.set()
        await asyncio.gather(*pending, return_exceptions=True)
        raise first_err
    return [t.result() for t in tasks]


def _chat_response(engine, req, inter) -> S.ChatCompletionResponse:
    tool_calls = None
    content: Optional[str] = None
    if inter.tool_calls:
        tool_calls = [
            S.ChatToolCall(function={
                "name": c["name"],
                "arguments": json.dumps(c["arguments"])
                if not isinstance(c["arguments"], str) else c["arguments"],
            })
            for c in inter.tool_calls
        ]
    else:
        content = inter.text
    logprobs_out = None
    if req.logprobs and inter.metadata.get("logprobs"):
        tok = engine.tokenizer
        entries = []
        k = req.top_logprobs or 0
        for tl in inter.metadata["logprobs"]:
            token_str = tok.decode([tl.token_id]) if tok else str(tl.token_id)
            entries.append(
                S.TokenLogprobOut(
                    token=token_str,
                    logprob=tl.logprob,
                    bytes=list(token_str.encode()),
                    top_logprobs=[
                        S.TopLogprobEntry(
                            token=(tok.decode([tid]) if tok else str(tid)),
                            logprob=lp,
                            bytes=list(
                                (tok.decode([tid]) if tok else str(tid)).encode()
                            ),
                        )
                        for tid, lp in tl.top[:k]
                    ],
                )
            )
        logprobs_out = S.ChoiceLogprobs(content=entries)
    usage = S.Usage(
        prompt_tokens=inter.prompt_tokens,
        completion_tokens=inter.completion_tokens,
        total_tokens=inter.prompt_tokens + inter.completion_tokens,
    )
    return S.ChatCompletionResponse(
        model=req.model,
        choices=[S.ChatChoice(
            message=S.ChatResponseMessage(
                content=content, tool_calls=tool_calls,
                reasoning_content=inter.metadata.get("reasoning_content"),
            ),
            finish_reason=inter.finish_reason,
            logprobs=logprobs_out,
        )],
        usage=usage,
    )


# -- completions ------------------------------------------------------------


async def handle_completions(request: web.Request) -> web.Response:
    app = request.app
    engine: InferenceEngine = app[ENGINE_KEY]
    try:
        req = S.CompletionRequest.model_validate(await request.json())
    except Exception as e:
        return _err(422, f"invalid request: {e}")
    if req.stream:
        return _err(501, "streaming is not supported on /v1/completions")
    # n>1 / best_of degraded to n=1 (reference completions.py:47-53)
    kw = _gen_kwargs(req)
    prompts = req.prompt if isinstance(req.prompt, list) else [req.prompt]
    if prompts and isinstance(prompts[0], int):
        prompt_ids = list(prompts)  # token-id prompt
        prompt_text = None
    else:
        prompt_text = str(prompts[0])
        if engine.tokenizer is None:
            return _err(400, "no tokenizer loaded")
        prompt_ids = engine.tokenizer.encode(prompt_text, add_bos=True)
    stops = [req.stop] if isinstance(req.stop, str) else list(req.stop or [])
    try:
        res = await _run_blocking(
            app, engine.generate, prompt_ids,
            max_completion_tokens=req.max_tokens or 16,
            stop_token_ids=engine.tokenizer.stop_tokens if engine.tokenizer else (),
            logprobs=req.logprobs is not None,
            **kw,
        )
    except (InferenceError, ValueError) as e:
        return _err(400, str(e))
    tok = engine.tokenizer
    text = tok.decode(res.token_ids, skip_special_tokens=True) if tok else ""
    finish = res.finish_reason
    for s in stops:
        i = text.find(s)
        if i != -1:
            text, finish = text[:i], "stop"
            break
    if req.echo and prompt_text is not None:
        text = prompt_text + text
    lp = None
    if req.logprobs is not None and res.logprobs:
        k = min(req.logprobs, len(res.logprobs[0].top) if res.logprobs else 0)
        toks, tlps, tops, offs = [], [], [], []
        off = 0
        for tl in res.logprobs:
            ts = tok.decode([tl.token_id]) if tok else str(tl.token_id)
            toks.append(ts)
            tlps.append(tl.logprob)
            tops.append({
                (tok.decode([tid]) if tok else str(tid)): v
                for tid, v in tl.top[:k]
            })
            offs.append(off)
            off += len(ts)
        lp = S.CompletionLogprobs(
            tokens=toks, token_logprobs=tlps, top_logprobs=tops, text_offset=offs
        )
    usage = S.Usage(
        prompt_tokens=res.prompt_tokens,
        completion_tokens=res.completion_tokens,
        total_tokens=res.prompt_tokens + res.completion_tokens,
    )
    return web.json_response(
        S.CompletionResponse(
            model=req.model,
            choices=[S.CompletionChoice(text=text, finish_reason=finish, logprobs=lp)],
            usage=usage,
        ).model_dump(exclude_none=True)
    )


# -- responses --------------------------------------------------------------


async def handle_responses(request: web.Request) -> web.Response:
    app = request.app
    engine: InferenceEngine = app[ENGINE_KEY]
    try:
        req = S.ResponsesRequest.model_validate(await request.json())
    except Exception as e:
        return _err(422, f"invalid request: {e}")
    interactions = []
    if req.instructions:
        interactions.append({"role": "system", "text": req.instructions})
    if isinstance(req.input, str):
        interactions.append({"role": "user", "text": req.input})
    else:
        for item in req.input:
            role = item.get("role", "user")
            content = item.get("content", "")
            if isinstance(content, list):
                content = "".join(
                    p.get("text", "") for p in content
                    if p.get("type") in ("input_text", "output_text", "text")
                )
            interactions.append({"role": role, "text": content})
    tools = None
    if req.tools:
        tools = [
            {"name": t.get("name"), "description": t.get("description"),
             "parameters": t.get("parameters")}
            for t in req.tools if t.get("type") == "function"
        ]
    kw = {}
    if req.temperature is not None:
        kw["temperature"] = req.temperature
    if req.top_p is not None:
        kw["top_p"] = req.top_p
    try:
        inter = await _run_blocking(
            app, engine.chat, interactions, tools=tools,
            max_completion_tokens=req.max_output_tokens or 1024, **kw,
        )
    except (InferenceError, ValueError) as e:
        return _err(400, str(e))
    output: list = []
    if inter.tool_calls:
        for c in inter.tool_calls:
            output.append(
                S.ResponsesFunctionCall(
                    name=c["name"],
                    arguments=json.dumps(c["arguments"])
                    if not isinstance(c["arguments"], str) else c["arguments"],
                )
            )
    else:
        output.append(
            S.ResponsesMessage(content=[S.ResponsesOutputText(text=inter.text)])
        )
    usage = S.ResponsesUsage(
        input_tokens=inter.prompt_tokens,
        output_tokens=inter.completion_tokens,
        total_tokens=inter.prompt_tokens + inter.completion_tokens,
    )
    return web.json_response(
        S.ResponsesResponse(model=req.model, output=output, usage=usage)
        .model_dump(exclude_none=True)
    )


async def handle_health(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def handle_metrics(request: web.Request) -> web.Response:
    from pie_tpu_torch.utils.metrics import get_metrics

    return web.Response(
        text=get_metrics().render(),
        content_type="text/plain",
    )


def create_app(
    engine: Optional[InferenceEngine] = None,
    settings: Optional[Settings] = None,
    device="cuda",
) -> web.Application:
    dev = resolve_device(device)
    settings = settings or get_settings()
    logging.basicConfig(level=settings.log_level)
    if engine is None:
        if not settings.model_path:
            raise RuntimeError("MODEL_PATH is not set")
        logger.info("loading model from %s", settings.model_path)
        if settings.batching:
            engine = BatchedInferenceEngine(
                model_path=settings.model_path,
                num_lanes=settings.num_lanes,
                num_pages=settings.num_pages,
                kv_quantized=settings.kv_quantized,
                scheduler_impl="native" if settings.native_scheduler else "python",
                device=dev,
            )
        else:
            engine = InferenceEngine(
                model_path=settings.model_path,
                max_seq_len=settings.max_seq_len,
                kv_quantized=settings.kv_quantized,
                device=dev,
            )
    concurrent = isinstance(engine, BatchedInferenceEngine)
    if settings.batching and not concurrent:
        raise ValueError("BATCHING=1 asks for continuous batching, but the "
                         "engine given is the single-stream InferenceEngine")
    if engine.device != dev:
        raise ValueError(f"engine runs on {engine.device}, app asked for {dev}")
    app = web.Application()
    app[ENGINE_KEY] = engine

    async def _init_lock(app):
        # created at startup so the lock binds to the serving event loop;
        # the batching engine handles concurrency itself
        app[LOCK_KEY] = contextlib.nullcontext() if concurrent else asyncio.Lock()

    app.on_startup.append(_init_lock)
    app.router.add_post("/v1/chat/completions", handle_chat)
    app.router.add_post("/v1/completions", handle_completions)
    app.router.add_post("/v1/responses", handle_responses)
    app.router.add_get("/health", handle_health)
    app.router.add_get("/metrics", handle_metrics)
    return app
