"""The port's copies of ``tokenizer/``, ``interaction/`` and
``utils/metrics.py`` (pie_tpu_torch): the 7 tests of tests/test_tokenizer.py
and tests/test_persistence.py::test_metrics_render on the port's modules
(offline: a tiny WordLevel tokenizer, no network), and each rendering and
encoding held against the JAX package's on the same inputs."""

import pytest

tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

from pie_tpu.tokenizer import Tokenizer as JTokenizer
from pie_tpu.tokenizer.chat_template import render_chat as jrender_chat
from pie_tpu.tokenizer.control_tokens import get_control_tokens as jget_control_tokens
from pie_tpu.utils.metrics import Metrics as JMetrics
from pie_tpu_torch.interaction import Content, Interaction, InteractionRole
from pie_tpu_torch.tokenizer import Tokenizer, get_control_tokens
from pie_tpu_torch.tokenizer.chat_template import render_chat
from pie_tpu_torch.tokenizer.control_tokens import CHATML, GEMMA, LLAMA3
from pie_tpu_torch.utils.metrics import Metrics


def _tiny_hf_tokenizer(control):
    from tokenizers import Tokenizer as RawTok, models, pre_tokenizers

    words = [
        "hello", "world", "how", "are", "you", "fine", "thanks", "a", "b",
        "user", "assistant", "system", "<unk>",
    ]
    specials = [t for t in control.all_control_tokens]
    vocab = {w: i for i, w in enumerate(specials + words)}
    raw = RawTok(models.WordLevel(vocab, unk_token="<unk>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    for s in specials:
        raw.add_special_tokens([s])
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=raw,
        bos_token=control.bos or None,
        eos_token=control.eos,
        unk_token="<unk>",
    )


def test_family_sniffing():
    assert get_control_tokens(eos_token="<|eot_id|>").family == "llama3"
    assert get_control_tokens(eos_token="<|im_end|>").family == "chatml"
    assert get_control_tokens(eos_token="<eos>").family == "gemma"
    assert get_control_tokens(family="llama3") is LLAMA3
    with pytest.raises(ValueError):
        get_control_tokens(family="nope")
    for eos in ("<|eot_id|>", "<|im_end|>", "<eos>", "<end_of_turn>", "other"):
        # two classes of one name: compare their fields
        assert (vars(get_control_tokens(eos_token=eos))
                == vars(jget_control_tokens(eos_token=eos)))


def test_render_chat_llama3():
    msgs = [
        {"role": "system", "text": "be brief"},
        {"role": "user", "text": "hello"},
    ]
    out = render_chat(msgs, LLAMA3)
    assert "<|start_header_id|>system<|end_header_id|>\n\nbe brief<|eot_id|>" in out
    assert "<|start_header_id|>user<|end_header_id|>\n\nhello<|eot_id|>" in out
    assert out.endswith("<|start_header_id|>assistant<|end_header_id|>\n\n")
    assert out == jrender_chat(msgs, jget_control_tokens(family="llama3"))


def test_render_chat_gemma_folds_system():
    msgs = [
        {"role": "system", "text": "be brief"},
        {"role": "user", "text": "hello"},
        {"role": "assistant", "text": "hi"},
    ]
    out = render_chat(msgs, GEMMA)
    assert "system" not in out  # folded into the user turn
    assert "be brief\n\nhello" in out
    assert "<start_of_turn>model" in out
    assert out == jrender_chat(msgs, jget_control_tokens(family="gemma"))
    # a system message with no user turn becomes the first user turn
    alone = [{"role": "system", "text": "be brief"}]
    assert render_chat(alone, GEMMA) == jrender_chat(alone, jget_control_tokens(
        family="gemma"))
    assert "<start_of_turn>user\nbe brief<end_of_turn>" in render_chat(alone, GEMMA)


def test_render_chat_tools_injected():
    msgs = [{"role": "user", "text": "hello"}]
    tools = [{"name": "get_weather", "parameters": {"type": "object"}}]
    for control in (CHATML, GEMMA, LLAMA3):
        out = render_chat(msgs, control, tools=tools)
        assert "get_weather" in out
        assert out == jrender_chat(msgs, jget_control_tokens(family=control.family),
                                   tools=tools)


def test_tokenizer_roundtrip_and_stops():
    for control in (LLAMA3, GEMMA):
        tok = Tokenizer(_tiny_hf_tokenizer(control), control)
        ids = tok.encode("hello world")
        assert tok.decode(ids) == "hello world"
        assert tok.token_to_id(control.end_of_turn) in tok.stop_tokens
        assert tok.token_to_id(control.eos) in tok.stop_tokens
        jtok = JTokenizer(_tiny_hf_tokenizer(control), jget_control_tokens(
            family=control.family))
        assert ids == jtok.encode("hello world")
        assert sorted(tok.stop_tokens) == sorted(jtok.stop_tokens)


def test_apply_chat_template_encodes():
    tok = Tokenizer(_tiny_hf_tokenizer(LLAMA3), LLAMA3)
    ids = tok.apply_chat_template([Interaction.simple("user", "hello world")],
                                  add_bos=True)
    assert ids[0] == tok.token_to_id("<|begin_of_text|>")
    text = tok.decode(ids)
    assert "hello world" in text
    assert "assistant" in text
    # Gemma: the system message folds into the user turn; the JAX package
    # encodes the same ids
    gtok = Tokenizer(_tiny_hf_tokenizer(GEMMA), GEMMA)
    chat = [{"role": "system", "text": "be brief"}, {"role": "user", "text": "hello"}]
    gids = gtok.apply_chat_template(chat, add_bos=True)
    assert gids[0] == gtok.token_to_id("<bos>")
    assert gtok.token_to_id("system") not in gids
    jtok = JTokenizer(_tiny_hf_tokenizer(GEMMA), jget_control_tokens(family="gemma"))
    assert gids == jtok.apply_chat_template(chat, add_bos=True)


def test_interaction_model():
    it = Interaction(
        role=InteractionRole.ASSISTANT,
        content=[
            Content.text_content("hi "),
            Content.tool_call_content("f", {"x": 1}, "call_1"),
            Content.text_content("there"),
        ],
        metadata={"finish_reason": "stop"},
    )
    assert it.text == "hi there"
    assert it.tool_calls == [{"name": "f", "arguments": {"x": 1}, "id": "call_1"}]
    assert it.finish_reason == "stop"
    d = it.to_dict()
    assert d["role"] == "assistant" and d["finish_reason"] == "stop"
    with pytest.raises(AttributeError):
        it.nope


def test_metrics_render():
    m, jm = Metrics(), JMetrics()
    for metrics in (m, jm):
        metrics.record_request(10, 5, ttft=0.02, latency=0.5)
        metrics.record_request(3, 1, ttft=None, latency=0.1, error=True)
    text = m.render()
    assert "pie_requests_total 2" in text
    assert "pie_request_errors_total 1" in text
    assert "pie_prompt_tokens_total 13" in text
    assert "pie_ttft_seconds_count 1" in text
    assert 'pie_request_seconds_bucket{le="0.5"} 2' in text
    # the port adds the batching service's queue wait, fed by its stamps
    assert "pie_queue_wait_seconds_count 0" in text
    ours = [x for x in text.splitlines() if not x.startswith("pie_queue_wait_seconds")]
    assert ours == jm.render().splitlines()
