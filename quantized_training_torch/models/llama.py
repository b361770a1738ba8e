"""LLaMA-family causal LM with quantization sites at every place the
reference annotates (reference: quantizer/xnnpack_quantizer_utils.py:85-505
and modules/quantizable/modeling_llama.py).

bf16 activations, f32 RoPE / softmax / norm statistics, GQA, an optional
fused q/k/v projection, and the two-tier quantized KV cache for serving.
Attention runs one of three paths:

  * flash attention (ops/flash_attention.py) when the config asks for it,
    no mask is needed, the shapes pass the gate below and every attention
    matmul site is off or a direct rounding: q/k/v are rounded before the
    kernel, the probabilities inside it (two-pass form) and o_proj's input
    rounding rides its output write;
  * fused decode over the cache's codes, qparams and residual ring,
    visibility taken from the cache lengths: the per-token symmetric int4
    or int8 cache through ops/int_kv_attention.py, the KIVI group-affine
    cache through ops/kivi_attention.py;
  * naive attention over materialized K/V with an additive mask, every
    quantization site explicit (scores scaling, softmax input, both
    matmuls' inputs).

The model speaks (B, S, H, D).  ``forward`` returns ``(logits, caches)``,
one cache per layer (see serving/kv_cache.py).  With ``config.kv_cache``
set, an S > 1 call with ``use_cache=True`` is a prefill that builds a
:class:`QuantizedKVCache` per layer and an S == 1 call a decode step that
appends to the caches it is given; ``decode_append=True`` appends an
S-token block (a speculative verify block) to the residual ring instead,
masked by ``residual_causal_mask`` on the naive path.  With
``kv_cache=None`` the cache is the static full-precision ring
(:class:`FullPrecisionCache`): each call writes its K/V at
``cache_index`` and attends over the ring with the slots not yet
written masked.
"""

from dataclasses import dataclass
from typing import List, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..numerics import quantize_fn, quantize_fn_unit
from ..ops.flash_attention import flash_attention
from ..ops.int_kv_attention import int_kv_decode_attention
from ..ops.kivi_attention import kivi_decode_attention
from ..quantize.config import OpCategory, QuantConfig
from ..serving.kv_cache import (
    MASK_VALUE, FullPrecisionCache, KVCacheConfig, append_per_slot,
    append_to_cache, cache_kv, init_cache, per_slot_mask, prefill_cache,
    residual_causal_mask,
)
from ..utils import resolve_device
from .layers import Embed, QDense, QRMSNorm, QSoftmax, QuantMixin

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "fuse_qkv_params", "causal_mask"]


def fuse_qkv_params(params: Mapping[str, torch.Tensor],
                    cfg: "LlamaConfig") -> dict:
    """Convert unfused params (``q_proj``/``k_proj``/``v_proj`` kernels) to
    the fused ``qkv_proj`` layout of ``LlamaConfig(fused_qkv=True)``.

    Column order is interleaved per kv head: for kv head j the fused block
    is [q_{j*g..j*g+g-1} | k_j | v_j] (g = H // KV query heads per group).
    Each output column's dot is unchanged, so the fused GEMM computes the
    same outputs as the three separate ones."""
    H, KV, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    group = H // KV
    out = dict(params)
    for name in params:
        if not name.endswith("q_proj.kernel"):
            continue
        base = name[:-len("q_proj.kernel")]
        q = out.pop(base + "q_proj.kernel")
        k = out.pop(base + "k_proj.kernel")
        v = out.pop(base + "v_proj.kernel")
        cin = q.shape[0]
        out[base + "qkv_proj.kernel"] = torch.cat([
            q.reshape(cin, KV, group * D),
            k.reshape(cin, KV, D),
            v.reshape(cin, KV, D),
        ], dim=-1).reshape(cin, KV * (group + 2) * D)
    return out


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # Two-tier (quantized) KV cache for serving; None = the static
    # full-precision ring of max_position_embeddings slots.
    kv_cache: Optional[KVCacheConfig] = None
    # Route eligible prefill attention through the flash kernel.
    use_flash_attention: bool = False
    # Route eligible decode steps (int-sym or KIVI cache) through the fused
    # decode kernels (codes dequantized on chip; no materialized K/V).
    use_fused_kivi: bool = True
    # One (hidden, KV*(group+2)*D) GEMM for q/k/v, columns interleaved per
    # kv head ([q-group | k | v]); fuse_qkv_params converts unfused params.
    fused_qkv: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Small config for tests / CPU smoke runs."""
        defaults = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
        )
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llama2_13b() -> "LlamaConfig":
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_hidden_layers=40, num_attention_heads=40)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """RoPE tables in float32: (..., seq, head_dim/2)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    angles = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (HF convention: split halves).  x: (B, S, H, D)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_mask(batch: int, q_len: int, kv_len: int, q_offset=0, *,
                device, dtype=torch.float32) -> torch.Tensor:
    """Additive causal mask of shape (B, 1, q_len, kv_len); the fill is the
    bf16 minimum, like HF models use the compute dtype's min."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.where(kv_pos <= q_pos, 0.0, MASK_VALUE).to(dtype)
    return mask[None, None].expand(batch, 1, q_len, kv_len)


def _direct_dtype(spec):
    """The dtype string if ``spec`` is a direct rounding (flash can host
    it), False if it needs machinery flash cannot host, None if off."""
    if spec is None:
        return None
    if spec.qscheme is None and spec.outlier_threshold is None:
        return spec.dtype
    return False


class LlamaAttention(nn.Module, QuantMixin):
    def __init__(self, cfg: LlamaConfig, qconfig: Optional[QuantConfig],
                 path: str, device):
        super().__init__()
        self.config, self.qconfig, self.path = cfg, qconfig, path
        H, KV, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        dense = lambda feat, name: QDense(
            cfg.hidden_size, feat, use_bias=False, qconfig=qconfig,
            path=f"{path}.{name}", dtype=cfg.torch_dtype, device=device)
        if cfg.fused_qkv:
            self.qkv_proj = dense(KV * (H // KV + 2) * D, "qkv_proj")
        else:
            self.q_proj = dense(H * D, "q_proj")
            self.k_proj = dense(KV * D, "k_proj")
            self.v_proj = dense(KV * D, "v_proj")
        self.o_proj = QDense(H * D, cfg.hidden_size, use_bias=False,
                             qconfig=qconfig, path=f"{path}.o_proj",
                             dtype=cfg.torch_dtype, device=device)
        self.softmax = QSoftmax(qconfig=qconfig, path=f"{path}.softmax",
                                dtype=cfg.torch_dtype)

    def forward(self, hidden, attention_mask, positions, use_cache=False,
                cache=None, prompt_len=None, cache_index=0,
                decode_append=False):
        cfg = self.config
        dtype = cfg.torch_dtype
        B, S, _ = hidden.shape
        H, KV, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim

        if cfg.fused_qkv:
            group = H // KV
            r = self.qkv_proj(hidden).reshape(B, S, KV, (group + 2) * D)
            q = r[..., :group * D].reshape(B, S, H, D)
            k = r[..., group * D:(group + 1) * D]
            v = r[..., (group + 1) * D:]
        else:
            # one rounding of the shared input feeds all three projections
            # when their specs agree
            shared = self._shared_input_quant(
                hidden, ("q_proj", "k_proj", "v_proj"), "qkv_pre_process")
            skip = shared is not None
            x = shared if skip else hidden
            q = self.q_proj(x, skip).reshape(B, S, H, D)
            k = self.k_proj(x, skip).reshape(B, S, KV, D)
            v = self.v_proj(x, skip).reshape(B, S, KV, D)

        cos, sin = rope_cos_sin(positions, D, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        new_cache = None
        kcfg = cfg.kv_cache
        # a two-tier prefill may run flash: the cache write is independent
        # of attention, and causality alone hides the padded kv slots
        # (positions >= prompt_len) from every real query row
        tier_prefill = (use_cache and kcfg is not None and S > 1
                        and not decode_append)
        if tier_prefill:
            # attend over the raw K/V; store them in the main tier
            # (prompt_len zeroes padded slots)
            new_cache = prefill_cache(
                init_cache(kcfg, B, KV, D, dtype, device=hidden.device),
                kcfg, k, v, length=prompt_len)
        elif use_cache and kcfg is not None:
            # decode: one token, or an S-token verify block
            # (decode_append), into the residual ring; nothing is ever
            # promoted at decode, so a caller rewinds by lowering res_len
            per_slot = cache.res_len.dim() == 1
            if per_slot and S != 1:
                raise ValueError("a per-slot (engine) cache decodes one "
                                 f"token a step, got {S}")
            c = (append_per_slot(cache, k, v) if per_slot
                 else append_to_cache(cache, k, v))
            new_cache = c
            ml = c.main_len if per_slot else c.main_len.expand(B)
            rl = c.res_len if per_slot else c.res_len.expand(B)
            if S > 1:
                # query i sees residual slots r <= res_len before + i
                if attention_mask is None:
                    attention_mask = residual_causal_mask(
                        kcfg, B, S, c.main_len, c.res_len - S)
            else:
                if (attention_mask is None
                        and self._int_kv_fused_eligible(kcfg)):
                    ctx = int_kv_decode_attention(
                        q[:, 0].contiguous(), c.k_codes, c.k_scale,
                        c.v_codes, c.v_scale,
                        c.k_res.to(dtype), c.v_res.to(dtype),
                        ml.contiguous(), rl.contiguous(),
                        bits=kcfg.sym_bits, int_dots=False,
                        k_transposed=False)
                    ctx = ctx.reshape(B, 1, H * D)
                    return self.o_proj(ctx), new_cache
                if (attention_mask is None
                        and self._kivi_fused_eligible(kcfg)):
                    ctx = kivi_decode_attention(
                        q[:, 0].contiguous(), c.k_codes, c.k_scale, c.k_zp,
                        c.v_codes, c.v_scale, c.v_zp,
                        c.k_res.to(dtype), c.v_res.to(dtype),
                        ml.contiguous(), rl.contiguous(),
                        bits_k=kcfg._pack_bits(kcfg.k_spec),
                        bits_v=kcfg._pack_bits(kcfg.v_spec))
                    ctx = ctx.reshape(B, 1, H * D)
                    return self.o_proj(ctx), new_cache
                if attention_mask is None:
                    # post-append: residual slot r visible iff r < res_len
                    attention_mask = per_slot_mask(kcfg, ml, rl - 1)
            k, v = cache_kv(c, kcfg, dtype)
        elif use_cache:
            # the static full-precision ring, written at cache_index; the
            # model's causal mask hides the slots not yet written
            T = cfg.max_position_embeddings
            if not 0 <= cache_index <= T - S:
                raise ValueError(f"{S} tokens at position {cache_index} "
                                 f"overrun the {T}-slot ring")
            if cache is None:
                cache = FullPrecisionCache(
                    *(torch.zeros((B, T, KV, D), dtype=dtype,
                                  device=hidden.device) for _ in range(2)))
            cache.k[:, cache_index:cache_index + S] = k
            cache.v[:, cache_index:cache_index + S] = v
            new_cache = cache
            k, v = cache.k, cache.v

        if self._flash_eligible(attention_mask, use_cache, S, D,
                                tier_prefill):
            ctx, o_prequantized = self._flash_path(q, k, v)
        else:
            ctx = self._naive_path(q, k, v, attention_mask, B, S)
            o_prequantized = False
        ctx = ctx.reshape(B, S, H * D)
        return self.o_proj(ctx, o_prequantized), new_cache

    def _attention_sites_clear(self) -> bool:
        """No quantization on the attention matmuls / scaling / softmax."""
        cfg_q = self.qconfig
        if cfg_q is None:
            return True
        if cfg_q.posit_exp or cfg_q.posit_exp_shifted or cfg_q.posit_reciprocal:
            return False
        path = self.path
        sites = [
            cfg_q.activation_spec(path, "matmul", OpCategory.GEMM, 0),
            cfg_q.activation_spec(path, "matmul", OpCategory.GEMM, 1),
            cfg_q.activation_spec(path, "mul", OpCategory.SCALING, 0),
            cfg_q.activation_spec(path, "softmax", OpCategory.ACTIVATION, 0),
            cfg_q.error_spec(path, "matmul", OpCategory.GEMM, 0),
        ]
        return all(s is None for s in sites)

    def _int_kv_fused_eligible(self, kcfg: KVCacheConfig) -> bool:
        """The fused int-sym decode gate: config flag on, sym-bits cache and
        no quantization on the attention sites."""
        if not self.config.use_fused_kivi or kcfg.sym_bits is None:
            return False
        return self._attention_sites_clear()

    def _kivi_fused_eligible(self, kcfg: KVCacheConfig) -> bool:
        """The fused KIVI decode gate: config flag on, both cache sides
        group-affine in the KIVI layout (K along tokens, V along features)
        and no quantization on the attention sites."""
        if not self.config.use_fused_kivi:
            return False
        if kcfg.k_spec is None or kcfg.v_spec is None:
            return False
        if kcfg.k_spec.ch_axis != 2 or kcfg.v_spec.ch_axis != 3:
            return False
        return self._attention_sites_clear()

    def _matmul_site(self, index, error=False):
        """:func:`_direct_dtype` of an attention-matmul input's activation
        (or error) spec."""
        cfg_q = self.qconfig
        if cfg_q is None:
            return None
        lookup = cfg_q.error_spec if error else cfg_q.activation_spec
        return _direct_dtype(lookup(self.path, "matmul", OpCategory.GEMM,
                                    index))

    def _flash_eligible(self, attention_mask, use_cache, S, D,
                        tier_prefill=False) -> bool:
        """The flash gate (reference: models/llama.py:389-427): config flag
        on, no cache or a two-tier prefill (never the full-precision ring
        nor a decode_append block), no mask, D % 128 == 0 and S % 128 == 0
        (the reference's tiling gate, kept so both packages take the same
        branch; the kernel itself takes any S and D 64 or 128), every
        attention-matmul site off or a direct rounding, no scaling, softmax
        or posit-softmax site, and error specs, if any, one direct rounding
        on both matmul inputs."""
        if not self.config.use_flash_attention or (use_cache
                                                   and not tier_prefill):
            return False
        if attention_mask is not None:
            return False
        if D % 128 != 0 or S % 128 != 0:
            return False
        cfg_q = self.qconfig
        if cfg_q is None:
            return True
        # input 0 is q and p, input 1 is k and v
        if self._matmul_site(0) is False or self._matmul_site(1) is False:
            return False
        if cfg_q.posit_exp or cfg_q.posit_exp_shifted or cfg_q.posit_reciprocal:
            return False
        if cfg_q.activation_spec(self.path, "mul", OpCategory.SCALING,
                                 0) is not None:
            return False
        if cfg_q.activation_spec(self.path, "softmax", OpCategory.ACTIVATION,
                                 0) is not None:
            return False
        e0, e1 = self._matmul_site(0, True), self._matmul_site(1, True)
        if e0 is False or e1 is False:
            return False
        return (e0 is None and e1 is None) or e0 == e1

    def _flash_path(self, q, k, v):
        """Quantization-fused flash attention (q/k/v in (B, S, H, D)).

        Returns (context, o_prequantized): when the o_proj input site is a
        direct rounding, the kernel rounds its own output and o_proj skips
        its forward input rounding (reference: models/llama.py:444-479)."""
        qd, kd = self._matmul_site(0), self._matmul_site(1)
        ed = self._matmul_site(0, True) or self._matmul_site(1, True)
        od = None
        if self.qconfig is not None:
            od = _direct_dtype(self.qconfig.activation_spec(
                f"{self.path}.o_proj", "linear", OpCategory.GEMM, 0)) or None
        out = flash_attention(
            q.transpose(1, 2).contiguous(),
            k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(),
            q_qfn=quantize_fn(qd) if qd else None,
            k_qfn=quantize_fn(kd) if kd else None,
            # probabilities lie in [0, 1]: the reference's unit quantizer
            p_qfn=quantize_fn_unit(qd) if qd else None,
            v_qfn=quantize_fn(kd) if kd else None,
            out_qfn=quantize_fn(od) if od else None,
            err_qfn=quantize_fn(ed) if ed else None)
        return out.transpose(1, 2), od is not None

    def _naive_path(self, q, k, v, attention_mask, B, S):
        dtype = self.config.torch_dtype
        H, D = self.config.num_attention_heads, self.config.head_dim
        qq = self.quant_input(q, "matmul", OpCategory.GEMM, 0)
        kk = self.quant_input(k, "matmul", OpCategory.GEMM, 1)
        vv = self.quant_input(v, "matmul", OpCategory.GEMM, 1,
                              hook="av_pre_process")
        if kk.shape[2] != H:                       # GQA: repeat kv heads
            rep = H // kk.shape[2]
            kk = torch.repeat_interleave(kk, rep, dim=2)
            vv = torch.repeat_interleave(vv, rep, dim=2)
        if attention_mask is None:
            attention_mask = causal_mask(B, S, kk.shape[1], 0,
                                         device=q.device)
        f32 = torch.float32
        scores = torch.einsum("bshd,bthd->bhst", qq.to(f32), kk.to(f32))
        scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=f32))
        scores = self.quant_mul(scores.to(dtype),
                                scale.to(dtype).to(q.device)).to(f32)
        scores = scores + attention_mask.to(f32)
        probs = self.softmax(scores.to(dtype))
        pp = self.quant_input(probs, "matmul", OpCategory.GEMM, 0,
                              hook="av_pre_process")
        return torch.einsum("bhst,bthd->bshd", pp.to(f32),
                            vv.to(f32)).to(dtype)


class LlamaMLP(nn.Module, QuantMixin):
    def __init__(self, cfg: LlamaConfig, qconfig, path: str, device):
        super().__init__()
        self.config, self.qconfig, self.path = cfg, qconfig, path
        dense = lambda fin, fout, name: QDense(
            fin, fout, use_bias=False, qconfig=qconfig,
            path=f"{path}.{name}", dtype=cfg.torch_dtype, device=device)
        I, Hd = cfg.intermediate_size, cfg.hidden_size
        self.gate_proj = dense(Hd, I, "gate_proj")
        self.up_proj = dense(Hd, I, "up_proj")
        self.down_proj = dense(I, Hd, "down_proj")

    def forward(self, x):
        shared = self._shared_input_quant(x, ("gate_proj", "up_proj"),
                                          "gateup_pre_process")
        skip = shared is not None
        x = shared if skip else x
        gate = self.gate_proj(x, skip)
        up = self.up_proj(x, skip)
        gate = self.quant_activation_input(gate, "silu")
        act = F.silu(gate.to(torch.float32)).to(self.config.torch_dtype)
        return self.down_proj(self.quant_mul(act, up))


class LlamaDecoderLayer(nn.Module, QuantMixin):
    def __init__(self, cfg: LlamaConfig, qconfig, path: str, device):
        super().__init__()
        self.qconfig, self.path = qconfig, path
        norm = lambda name: QRMSNorm(
            cfg.hidden_size, epsilon=cfg.rms_norm_eps, qconfig=qconfig,
            path=f"{path}.{name}", dtype=cfg.torch_dtype, device=device)
        self.input_layernorm = norm("input_layernorm")
        self.self_attn = LlamaAttention(cfg, qconfig, f"{path}.self_attn",
                                        device)
        self.post_attention_layernorm = norm("post_attention_layernorm")
        self.mlp = LlamaMLP(cfg, qconfig, f"{path}.mlp", device)

    def forward(self, hidden, attention_mask, positions, use_cache=False,
                cache=None, prompt_len=None, cache_index=0,
                decode_append=False):
        attn_out, new_cache = self.self_attn(
            self.input_layernorm(hidden), attention_mask, positions,
            use_cache, cache, prompt_len, cache_index, decode_append)
        hidden = self.quant_residual(hidden, attn_out, hook="attn_residual")
        mlp_out = self.mlp(self.post_attention_layernorm(hidden))
        return (self.quant_residual(hidden, mlp_out, hook="mlp_residual"),
                new_cache)


class LlamaModel(nn.Module, QuantMixin):
    def __init__(self, cfg: LlamaConfig, qconfig, path: str, device):
        super().__init__()
        self.config, self.qconfig, self.path = cfg, qconfig, path
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                  dtype=cfg.torch_dtype, device=device)
        # JAX param path "layers_{i}" is state-dict key "layers.{i}"
        self.layers = nn.ModuleList(
            LlamaDecoderLayer(cfg, qconfig, f"{path}.layers_{i}", device)
            for i in range(cfg.num_hidden_layers))
        self.norm = QRMSNorm(cfg.hidden_size, epsilon=cfg.rms_norm_eps,
                             qconfig=qconfig, path=f"{path}.norm",
                             dtype=cfg.torch_dtype, device=device)

    def forward(self, input_ids, attention_mask=None, positions=None,
                use_cache=False, caches=None, cache_index=0,
                prompt_len=None, decode_append=False):
        cfg = self.config
        B, S = input_ids.shape
        device = input_ids.device
        hidden = self.embed_tokens(input_ids)
        if positions is None:
            positions = (torch.arange(S, device=device)[None, :]
                         + cache_index).expand(B, S)
        if attention_mask is None and use_cache and cfg.kv_cache is None:
            # the full-precision ring: causal from cache_index, which also
            # hides every slot not yet written
            attention_mask = causal_mask(B, S, cfg.max_position_embeddings,
                                         cache_index, device=device)
        elif (attention_mask is None and use_cache and S > 1
              and not decode_append):
            if not (cfg.use_flash_attention and cfg.head_dim % 128 == 0
                    and S % 128 == 0):
                # prefill attends over the current tokens only; with a
                # padded prefill, prompt_len also masks the pad slots.
                # (Under the flash gate the mask stays None: causality
                # alone hides the pad slots from every real row.)
                attention_mask = causal_mask(B, S, S, 0, device=device)
                if prompt_len is not None:
                    kv_pos = torch.arange(S, device=device)[None, None, None]
                    attention_mask = torch.where(
                        kv_pos < torch.as_tensor(prompt_len, device=device),
                        attention_mask, MASK_VALUE)
        # (A two-tier decode step or verify block leaves the mask None: the
        # attention layer derives it from its cache's lengths.)
        new_caches = [] if use_cache else None
        for i, layer in enumerate(self.layers):
            hidden, c = layer(hidden, attention_mask, positions, use_cache,
                              caches[i] if caches is not None else None,
                              prompt_len, cache_index, decode_append)
            if use_cache:
                new_caches.append(c)
        return self.norm(hidden), new_caches


class LlamaForCausalLM(nn.Module, QuantMixin):
    """The causal LM.  Weights start as zeros; load them with
    ``load_state_dict`` (convert.params_from_jax, convert.random_params,
    quantize.build_storage).

    ``forward(input_ids, ...) -> (logits f32, caches)``; ``caches`` is None
    unless ``use_cache``: one :class:`QuantizedKVCache` per layer with
    ``config.kv_cache``, else one :class:`FullPrecisionCache`.  Runs on
    ``device``, CUDA by default (raises when CUDA is missing; tests pass
    ``device="cpu"``).  A CUDA forward through
    dense (unpacked) layers needs
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
    False``, so that cuBLAS sums in f32 as the reference does; it raises
    otherwise (``QDense``).
    """

    def __init__(self, config: LlamaConfig,
                 qconfig: Optional[QuantConfig] = None, *, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config, self.qconfig, self.path = config, qconfig, ""
        self.model = LlamaModel(config, qconfig, "model", device)
        if not config.tie_word_embeddings:
            self.lm_head = QDense(config.hidden_size, config.vocab_size,
                                  use_bias=False, qconfig=qconfig,
                                  path="lm_head",
                                  dtype=config.torch_dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.embedding.device

    def forward(self, input_ids, attention_mask=None, positions=None, *,
                use_cache: bool = False, caches: Optional[List] = None,
                cache_index: int = 0, prompt_len=None,
                decode_append: bool = False,
                last_logit_only: bool = False):
        hidden, new_caches = self.model(
            input_ids, attention_mask, positions, use_cache, caches,
            cache_index, prompt_len, decode_append)
        if last_logit_only:
            # only the last position's logits are consumed at prefill
            hidden = hidden[:, -1:]
        if self.config.tie_word_embeddings:
            emb = self.model.embed_tokens.embedding.to(hidden.dtype)
            logits = torch.matmul(hidden.to(torch.float32),
                                  emb.to(torch.float32).T).to(hidden.dtype)
        else:
            logits = self.lm_head(hidden)
        return logits.to(torch.float32), new_caches
