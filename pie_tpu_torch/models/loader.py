"""Model loading: config parsing, safetensors weights, quantize-on-load.

Port of the JAX package's ``pie_tpu/models/loader.py``: an HF-style
snapshot (config.json + *.safetensors [+ model.safetensors.index.json])
or a .gguf file, architecture dispatch through the registry, and group-wise
quantization when the config has a "quantization" block or the caller
passes one. Weights are read with ``safe_open(..., framework="pt")``, which
holds bf16 on its own (numpy has no bfloat16 unless ml_dtypes registered
one; published Llama checkpoints are bf16). They are stacked on the host,
moved to the device, and quantized there.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Optional

import torch

from pie_tpu_torch.models.config import QuantizationConfig, load_config_dict
from pie_tpu_torch.models.registry import get_model_class
from pie_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def load_safetensors_weights(model_path: Path) -> dict[str, torch.Tensor]:
    """Every weight as a CPU tensor in its stored dtype: the shards of the
    index first, else every *.safetensors file."""
    from safetensors import safe_open

    model_path = Path(model_path)
    index = model_path / "model.safetensors.index.json"
    if index.exists():
        with open(index) as f:
            files = [model_path / s for s in sorted(set(json.load(f)["weight_map"].values()))]
    else:
        files = sorted(model_path.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no safetensors found in {model_path}")
    weights: dict[str, torch.Tensor] = {}
    for file in files:
        with safe_open(file, framework="pt") as f:
            for key in f.keys():
                weights[key] = f.get_tensor(key)
    return weights


def resolve_model_path(model_path: str | Path) -> Path:
    """Local path passthrough, or an HF-hub snapshot for repo ids: a path
    that does not exist and looks like ``org/name`` is fetched (or served
    from the local hub cache) through huggingface_hub."""
    p = Path(model_path)
    if p.exists():
        return p
    s = str(model_path)
    if s.count("/") == 1 and not s.startswith((".", "/", "~")):
        try:
            from huggingface_hub import snapshot_download
        except ImportError as e:
            raise FileNotFoundError(
                f"{s} is not a local path and huggingface_hub is unavailable"
            ) from e
        logger.info("downloading model snapshot %s from the HF hub", s)
        try:
            return Path(snapshot_download(
                repo_id=s,
                allow_patterns=["*.safetensors", "*.json", "*.gguf",
                                "tokenizer.model", "*.txt"],
            ))
        except Exception as e:
            # a mistyped relative local path also looks like a repo id
            raise FileNotFoundError(
                f"{s!r} is neither an existing local path nor a "
                f"downloadable HF hub repo id ({type(e).__name__}: {e})"
            ) from e
    raise FileNotFoundError(f"model path {s} does not exist")


def _move(tree: dict, device) -> dict:
    """Every tensor of a nested dict -> ``device``, each host tensor dropped
    as it is moved."""
    out = {}
    for name in list(tree):
        node = tree.pop(name)
        out[name] = _move(node, device) if isinstance(node, dict) else node.to(device)
    return out


def _place(model, params: dict, device, qcfg: Optional[QuantizationConfig]) -> dict:
    """Host params -> ``device``, quantized there when ``qcfg`` (the text
    decoder's projections and head; a vision tower stays dense). The host
    copy is dropped as it is moved, so the peak stays near one dense copy
    on each side."""
    out = _move(params, device)
    if qcfg is not None:
        logger.info("quantizing weights: %d bits, group size %d", qcfg.bits,
                    qcfg.group_size)
        out = model.quantize_params(out, qcfg.group_size, qcfg.bits)
    return out


def load_model(
    model_path: str | Path,
    dtype=torch.bfloat16,
    quantization: Optional[QuantizationConfig] = None,
    device="cuda",
):
    """(model, params on ``device``) from a local HF-style snapshot
    directory, a .gguf file (or a directory holding one and no
    safetensors), or an HF-hub repo id.

    If the config has a "quantization" block, or ``quantization`` is
    passed, linear weights are group-wise quantized on load (a GGUF file
    only when ``quantization`` is passed, as in the JAX package)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    model_path = resolve_model_path(model_path)
    gguf_file = None
    if model_path.suffix == ".gguf":
        gguf_file = model_path
    elif model_path.is_dir() and not any(model_path.glob("*.safetensors")):
        ggufs = sorted(model_path.glob("*.gguf"))
        gguf_file = ggufs[0] if ggufs else None
    if gguf_file is not None:
        from pie_tpu_torch.models.gguf import load_gguf_model

        model, params = load_gguf_model(gguf_file, dtype=dtype, device="cpu")
        params = _place(model, params, dev, quantization)
    else:
        cfg_dict = load_config_dict(model_path)
        model = build_model(cfg_dict)
        params = model.from_hf_state_dict(load_safetensors_weights(model_path),
                                          dtype=dtype)
        qcfg = quantization or QuantizationConfig.from_dict(cfg_dict.get("quantization"))
        params = _place(model, params, dev, qcfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    logger.info("loaded %s in %.1f s", model_path, time.perf_counter() - t0)
    return model, params


def build_model(cfg_dict: dict[str, Any]):
    """Instantiate the right architecture from a config dict."""
    cls = get_model_class(cfg_dict.get("model_type", "llama"))
    return cls(_config_for(cls, cfg_dict))


def _config_for(cls, cfg_dict):
    # Convention: <Arch>Model has a module-level <Arch>Config with from_dict.
    import importlib

    mod = importlib.import_module(cls.__module__)
    for name in dir(mod):
        if name.endswith("Config") and name != "BaseConfig":
            return getattr(mod, name).from_dict(cfg_dict)
    raise ValueError(f"no config class found for {cls}")


# ---------------------------------------------------------------------------
# params (de)serialization: quantized checkpoints in the port's layout
# ---------------------------------------------------------------------------


def save_params(params: dict, path: str | Path):
    """Persist a params tree (dense or quantized) to safetensors, with a
    JSON description of its structure in the metadata (QuantizedTensor
    leaves carry bits / group_size / shape). Tensors keep their dtype."""
    from safetensors.torch import save_file

    from pie_tpu_torch.ops.quant import QuantizedTensor

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tensors: dict[str, torch.Tensor] = {}
    spec: dict[str, Any] = {}

    def visit(prefix: str, node):
        if isinstance(node, QuantizedTensor):
            spec[prefix] = {"kind": "quantized", "bits": node.bits,
                            "group_size": node.group_size, "shape": list(node.shape)}
            for f in ("packed", "scales", "biases"):
                tensors[f"{prefix}.{f}"] = getattr(node, f).detach().cpu().contiguous()
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(f"{prefix}.{k}" if prefix else k, v)
        else:
            spec[prefix] = {"kind": "array"}
            tensors[prefix] = node.detach().cpu().contiguous()

    visit("", params)
    save_file(tensors, str(path), metadata={"pie": json.dumps(spec)})


def load_params(path: str | Path, device="cuda") -> dict:
    """Inverse of :func:`save_params`, onto ``device``."""
    from safetensors import safe_open

    from pie_tpu_torch.ops.quant import QuantizedTensor

    dev = resolve_device(device)
    with safe_open(str(path), framework="pt") as f:
        spec = json.loads((f.metadata() or {}).get("pie", "{}"))
        data = {k: f.get_tensor(k) for k in f.keys()}
    out: dict = {}
    for key, info in spec.items():
        *parents, leaf = key.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        if info["kind"] == "quantized":
            node[leaf] = QuantizedTensor(
                packed=data[f"{key}.packed"].to(dev),
                scales=data[f"{key}.scales"].to(dev),
                biases=data[f"{key}.biases"].to(dev),
                bits=info["bits"], group_size=info["group_size"],
                shape=tuple(info["shape"]),
            )
        else:
            node[leaf] = data[key].to(dev)
    return out
