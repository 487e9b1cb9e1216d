"""Conversion into the port's models (port of `fa2_triton_tpu.models.convert`).

`llama_from_jax_params` takes the JAX package's LLaMA parameter tree as
numpy arrays and returns the port's `LlamaModel`; `llama_to_jax_params` is
the reverse mapping, of the parameters or of their gradients, so the two
sides can be compared leaf by leaf. `gpt2_from_jax_params` /
`gpt2_to_jax_params` do the same for the GPT-2 family (`models/gpt2.py`).
Parameter names and orientation are the same on both sides (`layers.3.wq`
is `tree["layers"][3]["wq"]`), so all are copies. A tree whose layers carry
a `router` (the MoE family, `models/moe.py`) needs an `MoEConfig`.

The Hugging Face loaders (`llama_params_from_hf` for Llama, Mistral, Qwen2
with its biases and Qwen3 with its q/k norms; `phi3_params_from_hf`,
`gemma_params_from_hf`, `gemma2_params_from_hf`, `gpt2_params_from_hf`)
take a `transformers` model object and read only its `.config` and
`.state_dict()`: this module never imports `transformers`. Each builds the
JAX package's parameter tree in fp32 numpy, with the same arithmetic (Linear
weights transposed to [in, out], Gemma's norms stored as w + 1 and its
embedding scaled by sqrt(dim)), and copies it into the port's model, so its
leaves equal the JAX loader's tree converted by `llama_from_jax_params`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from fa2_triton_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from fa2_triton_tpu_torch.models.llama import LlamaConfig, LlamaModel
from fa2_triton_tpu_torch.utils import resolve_device

_FP32_KEYS = ("attn_norm", "mlp_norm", "bq", "bk", "bv", "q_norm", "k_norm",
              "post_attn_norm", "post_mlp_norm")


def _to_torch(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; reinterpret the bits.
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device=device, dtype=dtype)


@torch.no_grad()
def llama_from_jax_params(params_np: Dict[str, Any], cfg: LlamaConfig,
                          device=None, dtype=None) -> LlamaModel:
    """Copy a JAX LLaMA parameter tree ({"embed", "layers": [...],
    "final_norm", "lm_head"}, leaves numpy arrays) into a `LlamaModel`.
    Matmul weights, MoE experts and the embedding take `dtype` (default
    `cfg.dtype`); norms, biases and the MoE router stay fp32. Layers with a
    "router" need an `MoEConfig` (`models/moe.py`), and an `MoEConfig` needs
    a router in every layer. `device` defaults to the GPU
    (`resolve_device`)."""
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if len(params_np["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params_np['layers'])} layers in the tree, cfg says {cfg.n_layers}")
    moe = bool(getattr(cfg, "n_experts", 0))
    if any(("router" in src) != moe for src in params_np["layers"]):
        raise ValueError("a tree with a router in every layer needs an MoEConfig "
                         "(models/moe.py), and a tree without routers a LlamaConfig")
    model = LlamaModel(cfg, device=device)
    model.embed.copy_(_to_torch(params_np["embed"], dtype, device))
    model.lm_head.copy_(_to_torch(params_np["lm_head"], dtype, device))
    model.final_norm.copy_(_to_torch(params_np["final_norm"], torch.float32, device))
    for layer, src in zip(model.layers, params_np["layers"]):
        own = dict(layer.named_parameters(recurse=False))
        unknown = set(src) - set(own) - set(_FP32_KEYS)
        if unknown:
            raise ValueError(f"unknown layer keys {sorted(unknown)}")
        for key, p in own.items():
            if key not in _FP32_KEYS or key in src:
                p.copy_(_to_torch(src[key], p.dtype, device))
        for key in sorted(set(src) - set(own)):
            setattr(layer, key, torch.nn.Parameter(_to_torch(src[key], torch.float32, device)))
    return model


def jax_path(name: str) -> Tuple[Union[str, int], ...]:
    """A port parameter name as a path into the JAX tree:
    "layers.3.wq" -> ("layers", 3, "wq"), "embed" -> ("embed",)."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16 of its own: widen (exactly) to fp32.
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


@torch.no_grad()
def gpt2_from_jax_params(params_np: Dict[str, Any], cfg: GPT2Config,
                         device=None, dtype=None) -> GPT2Model:
    """Copy a JAX GPT-2 parameter tree ({"wte", "wpe", "layers": [...],
    "lnf_g", "lnf_b"[, "lm_head"]}, leaves numpy arrays) into a
    `GPT2Model`. Matmul weights and embeddings take `dtype` (default
    `cfg.dtype`); norms and biases stay fp32. A tree with "lm_head" needs
    an untied cfg and one without it a tied cfg. `device` defaults to the
    GPU (`resolve_device`)."""
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if ("lm_head" in params_np) == cfg.tie_embeddings:
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but the tree "
                         f"{'has' if 'lm_head' in params_np else 'lacks'} an lm_head")
    if len(params_np["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params_np['layers'])} layers in the tree, cfg says {cfg.n_layers}")
    model = GPT2Model(cfg, device=device)
    for name, p in model.named_parameters():
        path = jax_path(name)
        src = params_np["layers"][path[1]][path[2]] if path[0] == "layers" else params_np[path[0]]
        p.copy_(_to_torch(src, p.dtype, device))
    unknown = {k for layer in params_np["layers"] for k in layer} - set(
        dict(model.layers[0].named_parameters()))
    if unknown:
        raise ValueError(f"unknown layer keys {sorted(unknown)}")
    return model


@torch.no_grad()
def llama_to_jax_params(model: LlamaModel, grads: bool = False) -> Dict[str, Any]:
    """The JAX tree {"embed", "layers": [...], "final_norm", "lm_head"} of a
    `LlamaModel`'s parameters as numpy arrays (bf16 widened to fp32), or of
    their `.grad`s with `grads=True` (a parameter without a grad raises)."""
    tree: Dict[str, Any] = {"layers": [{} for _ in model.layers]}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if t is None:
            raise ValueError(f"{name} has no gradient")
        path = jax_path(name)
        if path[0] == "layers":
            tree["layers"][path[1]][path[2]] = _to_numpy(t)
        else:
            tree[path[0]] = _to_numpy(t)
    return tree


def gpt2_to_jax_params(model: GPT2Model, grads: bool = False) -> Dict[str, Any]:
    """The JAX tree {"wte", "wpe", "layers": [...], "lnf_g", "lnf_b"[,
    "lm_head"]} of a `GPT2Model`'s parameters or `.grad`s: the names map
    to paths as a `LlamaModel`'s do."""
    return llama_to_jax_params(model, grads)


# ---------------------------------------------------------------- Hugging Face


def _state(hf_model) -> Dict[str, np.ndarray]:
    """The state dict as fp32 numpy arrays (a bf16 or fp16 checkpoint is
    widened exactly)."""
    return {k: v.detach().cpu().float().numpy() for k, v in hf_model.state_dict().items()}


def _t(x: np.ndarray) -> np.ndarray:
    """A Linear weight [out, in] as the model's [in, out]."""
    return np.ascontiguousarray(x.T)


def _rope_factors_from_hf(hf_config):
    """HF `rope_scaling` -> `LlamaConfig.rope_factors` (Llama-3.x
    NTK-by-parts); None passes through, any other kind raises."""
    rs = getattr(hf_config, "rope_scaling", None)
    if rs is None:
        return None
    kind = rs.get("rope_type", rs.get("type"))
    if kind == "default":
        return None
    if kind != "llama3":
        raise NotImplementedError(f"unsupported rope_scaling type: {kind!r}")
    return (float(rs["factor"]), float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]), float(rs["original_max_position_embeddings"]))


def _window_pattern_from_hf(hf_config):
    """Per-layer sliding flags: Qwen2's first `max_window_layers` layers run
    full attention even with use_sliding_window (HF `layer_types`); None
    when every layer slides."""
    if not (getattr(hf_config, "sliding_window", None)
            and getattr(hf_config, "use_sliding_window", True)):
        return None
    lt = getattr(hf_config, "layer_types", None)
    if lt is not None:
        pattern = tuple(t == "sliding_attention" for t in lt)
    else:
        mwl = getattr(hf_config, "max_window_layers", hf_config.num_hidden_layers)
        pattern = tuple(i >= mwl for i in range(hf_config.num_hidden_layers))
    return None if all(pattern) else pattern


def llama_config_from_hf(hf_config, dtype=torch.float32) -> LlamaConfig:
    """A `LlamaConfig` from a Llama / Mistral / Qwen2 / Qwen3 HF config.
    HF's sliding_window counts the attending token itself, the port's
    window counts the previous tokens only: ours is HF's - 1."""
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        hidden_dim=hf_config.intermediate_size,
        head_dim=getattr(hf_config, "head_dim", None)
        or hf_config.hidden_size // hf_config.num_attention_heads,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        rope_factors=_rope_factors_from_hf(hf_config),
        norm_eps=float(hf_config.rms_norm_eps),
        max_seq_len=hf_config.max_position_embeddings,
        dtype=dtype,
        qkv_bias=bool(getattr(hf_config, "attention_bias", False)),
        sliding_window=(int(hf_config.sliding_window) - 1
                        if getattr(hf_config, "sliding_window", None)
                        and getattr(hf_config, "use_sliding_window", True) else -1),
        window_pattern=_window_pattern_from_hf(hf_config),
    )


def _head(sd: Dict[str, np.ndarray], embed: np.ndarray) -> np.ndarray:
    """The untied head [dim, V], or the embedding's transpose when tied."""
    return _t(sd["lm_head.weight"]) if "lm_head.weight" in sd else _t(embed)


def llama_params_from_hf(hf_model, dtype=torch.bfloat16,
                         device=None) -> Tuple[LlamaModel, LlamaConfig]:
    """A `LlamaForCausalLM` (or Mistral / Qwen2 / Qwen3) -> (the port's
    model, its config). Qwen2's q/k/v biases and Qwen3's per-head q/k
    norms are read from the state dict; a missing lm_head means tied
    embeddings. `device` defaults to the GPU (`resolve_device`)."""
    cfg = llama_config_from_hf(hf_model.config, dtype=dtype)
    sd = _state(hf_model)
    has_bias = "model.layers.0.self_attn.q_proj.bias" in sd
    has_qk_norm = "model.layers.0.self_attn.q_norm.weight" in sd
    cfg = dataclasses.replace(cfg, qkv_bias=has_bias)
    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layer = {}
        if has_bias:
            layer.update({f"b{c}": sd[p + f"self_attn.{c}_proj.bias"] for c in "qkv"})
        if has_qk_norm:
            layer.update(q_norm=sd[p + "self_attn.q_norm.weight"],
                         k_norm=sd[p + "self_attn.k_norm.weight"])
        layer.update({
            "attn_norm": sd[p + "input_layernorm.weight"],
            "wq": _t(sd[p + "self_attn.q_proj.weight"]),
            "wk": _t(sd[p + "self_attn.k_proj.weight"]),
            "wv": _t(sd[p + "self_attn.v_proj.weight"]),
            "wo": _t(sd[p + "self_attn.o_proj.weight"]),
            "mlp_norm": sd[p + "post_attention_layernorm.weight"],
            "w_gate": _t(sd[p + "mlp.gate_proj.weight"]),
            "w_up": _t(sd[p + "mlp.up_proj.weight"]),
            "w_down": _t(sd[p + "mlp.down_proj.weight"]),
        })
        layers.append(layer)
    embed = sd["model.embed_tokens.weight"]
    tree = {"embed": embed, "layers": layers, "final_norm": sd["model.norm.weight"],
            "lm_head": _head(sd, embed)}
    return llama_from_jax_params(tree, cfg, device=device), cfg


def phi3_params_from_hf(hf_model, dtype=torch.bfloat16,
                        device=None) -> Tuple[LlamaModel, LlamaConfig]:
    """A `Phi3ForCausalLM`: Llama with packed projections (`qkv_proj` is
    [q; k; v] on the output dim, `gate_up_proj` [gate; up]), split here.
    rope_scaling (longrope) raises."""
    hc = hf_model.config
    sw = getattr(hc, "sliding_window", None)
    cfg = LlamaConfig(
        vocab_size=hc.vocab_size, dim=hc.hidden_size, n_layers=hc.num_hidden_layers,
        n_heads=hc.num_attention_heads,
        n_kv_heads=getattr(hc, "num_key_value_heads", hc.num_attention_heads),
        hidden_dim=hc.intermediate_size, head_dim=hc.hidden_size // hc.num_attention_heads,
        rope_theta=float(getattr(hc, "rope_theta", 10000.0)), norm_eps=float(hc.rms_norm_eps),
        max_seq_len=hc.max_position_embeddings, dtype=dtype,
        sliding_window=int(sw) - 1 if sw else -1,
    )
    rs = getattr(hc, "rope_scaling", None)
    if rs is not None:
        raise NotImplementedError(f"phi3 rope_scaling {rs.get('type')!r} (longrope) not supported")
    sd = _state(hf_model)
    q_sz, kv_sz = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        qkv = _t(sd[p + "self_attn.qkv_proj.weight"])
        gate_up = _t(sd[p + "mlp.gate_up_proj.weight"])
        layers.append({
            "attn_norm": sd[p + "input_layernorm.weight"],
            "wq": qkv[:, :q_sz], "wk": qkv[:, q_sz:q_sz + kv_sz], "wv": qkv[:, q_sz + kv_sz:],
            "wo": _t(sd[p + "self_attn.o_proj.weight"]),
            "mlp_norm": sd[p + "post_attention_layernorm.weight"],
            "w_gate": gate_up[:, :cfg.hidden_dim], "w_up": gate_up[:, cfg.hidden_dim:],
            "w_down": _t(sd[p + "mlp.down_proj.weight"]),
        })
    embed = sd["model.embed_tokens.weight"]
    tree = {"embed": embed, "layers": layers, "final_norm": sd["model.norm.weight"],
            "lm_head": _head(sd, embed)}
    return llama_from_jax_params(tree, cfg, device=device), cfg


def _gemma_act(hc) -> str:
    """HF hidden_activation -> the model's activation; others raise."""
    act = getattr(hc, "hidden_activation", None) or getattr(hc, "hidden_act", "gelu_pytorch_tanh")
    table = {"gelu_pytorch_tanh": "gelu_tanh", "gelu_new": "gelu_tanh", "gelu": "gelu"}
    if act not in table:
        raise NotImplementedError(f"unsupported gemma activation: {act!r}")
    return table[act]


def _gemma_tree(sd: Dict[str, np.ndarray], cfg: LlamaConfig, post_norms: bool) -> Dict[str, Any]:
    """Gemma's tree: norms stored as w + 1 (Gemma normalises by 1 + w), the
    embedding scaled by sqrt(dim) in fp32 and the tied head left unscaled.
    With `post_norms` (Gemma2) both sublayer outputs are normed, and the
    pre-MLP norm is "pre_feedforward_layernorm"."""
    def norm(name):
        return sd[name] + np.float32(1.0)

    layers = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        layer = {
            "attn_norm": norm(p + "input_layernorm.weight"),
            "wq": _t(sd[p + "self_attn.q_proj.weight"]),
            "wk": _t(sd[p + "self_attn.k_proj.weight"]),
            "wv": _t(sd[p + "self_attn.v_proj.weight"]),
            "wo": _t(sd[p + "self_attn.o_proj.weight"]),
            "w_gate": _t(sd[p + "mlp.gate_proj.weight"]),
            "w_up": _t(sd[p + "mlp.up_proj.weight"]),
            "w_down": _t(sd[p + "mlp.down_proj.weight"]),
        }
        if post_norms:
            layer.update(post_attn_norm=norm(p + "post_attention_layernorm.weight"),
                         mlp_norm=norm(p + "pre_feedforward_layernorm.weight"),
                         post_mlp_norm=norm(p + "post_feedforward_layernorm.weight"))
        else:
            layer["mlp_norm"] = norm(p + "post_attention_layernorm.weight")
        layers.append(layer)
    raw = sd["model.embed_tokens.weight"]
    return {"embed": raw * np.sqrt(np.float32(cfg.dim)), "layers": layers,
            "final_norm": norm("model.norm.weight"), "lm_head": _head(sd, raw)}


def _gemma_config(hc, dtype, **extra) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=hc.vocab_size, dim=hc.hidden_size, n_layers=hc.num_hidden_layers,
        n_heads=hc.num_attention_heads, n_kv_heads=hc.num_key_value_heads,
        hidden_dim=hc.intermediate_size, head_dim=hc.head_dim,
        rope_theta=float(getattr(hc, "rope_theta", 10000.0)), norm_eps=float(hc.rms_norm_eps),
        max_seq_len=hc.max_position_embeddings, dtype=dtype, hidden_act=_gemma_act(hc), **extra)


def gemma_params_from_hf(hf_model, dtype=torch.bfloat16,
                         device=None) -> Tuple[LlamaModel, LlamaConfig]:
    """A `GemmaForCausalLM`: (1 + w) norms and the sqrt(dim) embedding scale
    absorbed into the weights, GeGLU as `hidden_act`, an explicit head_dim."""
    hc = hf_model.config
    cfg = _gemma_config(hc, dtype,
                        logit_softcap=float(getattr(hc, "final_logit_softcapping", 0.0) or 0.0))
    return llama_from_jax_params(_gemma_tree(_state(hf_model), cfg, False), cfg, device=device), cfg


def gemma2_params_from_hf(hf_model, dtype=torch.bfloat16,
                          device=None) -> Tuple[LlamaModel, LlamaConfig]:
    """A `Gemma2ForCausalLM`: Gemma plus post-norms on both sublayers,
    attention softcapping (`attn_softcap`), sliding windows on the even
    layers (`alt_window`), the scale from query_pre_attn_scalar
    (`attn_scale`) and final-logit softcapping (`logit_softcap`)."""
    hc = hf_model.config
    cfg = _gemma_config(
        hc, dtype, sliding_window=int(hc.sliding_window) - 1, alt_window=True,
        attn_scale=float(hc.query_pre_attn_scalar) ** -0.5,
        attn_softcap=float(hc.attn_logit_softcapping or 0.0),
        logit_softcap=float(hc.final_logit_softcapping or 0.0))
    return llama_from_jax_params(_gemma_tree(_state(hf_model), cfg, True), cfg, device=device), cfg


def gpt2_params_from_hf(hf_model, dtype=torch.float32,
                        device=None) -> Tuple[GPT2Model, GPT2Config]:
    """A `GPT2LMHeadModel` (Conv1D weights, already [in, out]; tied head)
    -> (the port's `GPT2Model`, its config)."""
    hc = hf_model.config
    cfg = GPT2Config(vocab_size=hc.vocab_size, dim=hc.n_embd, n_layers=hc.n_layer,
                     n_heads=hc.n_head, hidden_dim=4 * hc.n_embd, max_seq_len=hc.n_positions,
                     norm_eps=float(hc.layer_norm_epsilon), dtype=dtype, tie_embeddings=True)
    sd = _state(hf_model)
    names = {"ln1_g": "ln_1.weight", "ln1_b": "ln_1.bias", "w_qkv": "attn.c_attn.weight",
             "b_qkv": "attn.c_attn.bias", "w_proj": "attn.c_proj.weight",
             "b_proj": "attn.c_proj.bias", "ln2_g": "ln_2.weight", "ln2_b": "ln_2.bias",
             "w_fc": "mlp.c_fc.weight", "b_fc": "mlp.c_fc.bias", "w_out": "mlp.c_proj.weight",
             "b_out": "mlp.c_proj.bias"}
    tree = {"wte": sd["transformer.wte.weight"], "wpe": sd["transformer.wpe.weight"],
            "layers": [{k: sd[f"transformer.h.{i}.{v}"] for k, v in names.items()}
                       for i in range(cfg.n_layers)],
            "lnf_g": sd["transformer.ln_f.weight"], "lnf_b": sd["transformer.ln_f.bias"]}
    return gpt2_from_jax_params(tree, cfg, device=device), cfg
