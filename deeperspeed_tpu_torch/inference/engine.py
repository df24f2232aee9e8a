"""Serving engine: continuous batching over a paged KV cache.

The port of `InferenceEngine` in `deeperspeed_tpu/inference/engine.py`,
for the GPT-NeoX and GPT-2 families on one device. It is driven by the same
``"inference"`` config block (`runtime.config.parse_inference_block`)
and the ``weights`` choice of the ``"quantization"`` block, casts (or
int8-quantizes) weights with `module_inject.prepare_inference_params`,
and runs the model's own block functions (`gpt_neox._block_qkv` /
`_block_post_attn`), so decode cannot drift from the full forward.

Execution model:

- **Prefill/decode split.** New requests run one bucketed prefill
  (whole prompt, causal attention through the flash-prefill kernel, K/V
  written to their pages in whole-page scatters); in-flight requests
  run one decode step each (one token through the paged
  decode-attention kernel).
- **Fixed shapes.** The scheduler only emits the configured bucket
  shapes (prefill per (batch, length) bucket, decode per batch bucket),
  as in the JAX package; PyTorch runs eagerly, so a bucket costs no
  compile here.
- **State.** The page pools are updated in place; weights and the
  rotary cache are read-only.
- **int8 serving.** ``quantization.weights: "int8"`` rests the block
  matmul weights as int8 with per-channel scales; every block matmul
  goes through the weight-only int8 kernel (`gpt_neox._wmat`).
  ``inference.kv_cache_dtype: "int8"`` makes the pools `QuantizedPages`:
  K/V quantize per (head, slot) as they are written, prefill attention
  still runs on the fresh K/V, and decode runs the int8 paged-decode
  kernel. ``inference.kernel`` switches both kernels with the decode
  kernel: ``"xla"`` takes every plain version.

Sampling is deterministic: temperature 0 (default) is argmax;
temperature > 0 draws from the softmax with the engine's own
`torch.Generator`, seeded from the config seed.

Not ported yet (each raises at construction, and ROADMAP.md lists it):
the prefix cache, speculative decoding, disaggregated roles and the
router, admission control, serving fault injection, the hang watchdog,
telemetry spans and a model-parallel mesh. A prefill or decode exception propagates:
the quarantine/retry layer comes with the robustness slice.
"""

import time

import numpy as np
import torch

from ..models import gpt2 as gpt2_mod
from ..models import gpt_neox as neox
from ..module_inject.replace_module import prepare_inference_params
from ..ops.hopper.decode_attention import paged_decode_attention
from ..runtime.config import (parse_inference_block,
                              parse_quantization_block)
from ..runtime.config_utils import DeepSpeedConfigError, load_config_json
from ..runtime.precision import resolve_kv_cache_dtype
from ..utils.device import resolve_device
from .admission import validate_priority
from .kv_cache import (PagedKVCache, QuantizedPages, pages_for_tokens,
                       quantize_kv)
from .metrics import ServeRequestMetrics
from .scheduler import RUNNING, ContinuousBatchingScheduler, Request


def _pow2_ladder(lo, hi):
    """lo, 2·lo, 4·lo, ... capped at hi (hi appended if not reached)."""
    out, v = [], lo
    while v < hi:
        out.append(v)
        v *= 2
    out.append(hi)
    return sorted(set(out))


def _not_ported(what, slice_name):
    return DeepSpeedConfigError(
        f"{what} is not ported to deeperspeed_tpu_torch yet ({slice_name} "
        f"slice; see ROADMAP.md)")


class _Family:
    """The model-family seams the serving loop needs: token embedding at
    absolute positions, rotary rows, LM head (the JAX `_Family`). The
    block body is the shared `gpt_neox._block_qkv` / `_block_post_attn`;
    GPT-2 runs it with a zero-width rotary cache and adds its learned
    ``wpe`` row at each token's position, and its head is tied (the
    LM head reads ``embed.wte`` when there is no ``embed_out``)."""

    def __init__(self, model, max_seq_len, device):
        self.cfg = model.config
        if isinstance(model, neox.GPTNeoX):
            self.kind = "gpt_neox"
            self._cos, self._sin, self.rot_dim = neox._rotary_cache(
                self.cfg, max_seq_len, device=device)
        elif isinstance(model, gpt2_mod.GPT2):
            self.kind = "gpt2"
            self._cos = torch.zeros((max_seq_len, 0), device=device)
            self._sin = torch.zeros((max_seq_len, 0), device=device)
            self.rot_dim = 0
        else:
            raise DeepSpeedConfigError(
                f"InferenceEngine serves the GPT-NeoX / GPT-2 families; "
                f"got {type(model).__name__}")

    def embed(self, params, tokens, positions):
        """tokens [...] at their absolute ``positions`` (broadcastable
        to tokens: [1, S] in a prefill, [B] in a decode step) → [..., H];
        GPT-2 adds its ``wpe`` rows there."""
        x = params["embed"]["wte"][tokens]
        if self.kind == "gpt2":
            x = x + params["embed"]["wpe"][positions]
        return x

    def cos_sin_prefill(self, seqlen):
        return self._cos[:seqlen], self._sin[:seqlen], self.rot_dim

    def cos_sin_decode(self, positions):
        """Per-row rotary rows at `positions` [B] → ([B, 1, rot], ...)."""
        return (self._cos[positions][:, None, :],
                self._sin[positions][:, None, :], self.rot_dim)

    def head(self, params, h):
        """Final-norm hidden [B, H] → logits [B, V] (fp32)."""
        return neox.lm_head(params, h)


class InferenceEngine:
    """Continuous-batching serving over the paged KV cache.

    ``model`` is a `models.gpt_neox.GPTNeoX` or a `models.gpt2.GPT2`;
    ``config`` a dict or JSON
    path holding the ``"inference"`` block; ``params`` an optional
    ``{dotted name: tensor}`` state dict (else the model's own
    parameters). ``device`` defaults to ``"cuda"`` and raises when CUDA
    is absent; the CPU must be asked for (``device="cpu"``).
    """

    def __init__(self, model, config=None, params=None, device=None,
                 mesh=None):
        self.model = model
        cfg = model.config
        self.device = resolve_device(device, "InferenceEngine")
        if getattr(cfg, "moe_num_experts", 0):
            raise DeepSpeedConfigError(
                "serving MoE models is not supported yet: the decode "
                "block would silently drop the expert routing")
        if getattr(cfg, "attention_engine", "dense") != "dense":
            raise DeepSpeedConfigError(
                "serving needs attention_engine='dense' (the block-"
                "sparse engine has no decode variant)")
        if mesh is not None:
            raise _not_ported("a model-parallel mesh", "scale-out")

        # -- config --------------------------------------------------------
        if config is None:
            raise DeepSpeedConfigError(
                "InferenceEngine requires a config with an 'inference' "
                "block")
        d = config if isinstance(config, dict) else load_config_json(config)
        self.inference_params = parse_inference_block(d)
        quantization = parse_quantization_block(d) or None
        if not self.inference_params:
            raise DeepSpeedConfigError(
                "the 'inference' config block is required (with "
                "\"enabled\": true) to build an InferenceEngine")
        ip = self.inference_params
        self._reject_unported(d, ip)

        self.page_size = ip["page_size"]
        self.max_seq_len = ip["max_seq_len"] or cfg.max_seq_len
        if self.max_seq_len > cfg.max_seq_len:
            raise DeepSpeedConfigError(
                f"inference.max_seq_len {self.max_seq_len} exceeds the "
                f"model's max_seq_len {cfg.max_seq_len}")
        if self.max_seq_len % self.page_size:
            raise DeepSpeedConfigError(
                f"the serving window max_seq_len {self.max_seq_len} must "
                f"be a multiple of page_size {self.page_size} (the paged "
                f"re-prefill ladder cannot cover a misaligned tail); set "
                f"inference.max_seq_len explicitly")
        if ip["num_pages"] - 1 < pages_for_tokens(self.max_seq_len,
                                                  self.page_size):
            raise DeepSpeedConfigError(
                f"inference.num_pages {ip['num_pages']} cannot hold even "
                f"one max_seq_len sequence "
                f"({pages_for_tokens(self.max_seq_len, self.page_size)} "
                f"pages + the reserved trash page)")
        self.max_batch_size = ip["max_batch_size"]
        self.temperature = ip["temperature"]
        self.seed = ip["seed"]
        self._attn_backend = ip["kernel"]

        if ip["prefill_lengths"]:
            bad = [b for b in ip["prefill_lengths"] if b > self.max_seq_len]
            if bad:
                raise DeepSpeedConfigError(
                    f"inference.prefill_lengths {bad} exceed the serving "
                    f"window max_seq_len {self.max_seq_len}")
            self.prefill_lengths = ip["prefill_lengths"]
        else:
            self.prefill_lengths = _pow2_ladder(self.page_size,
                                                self.max_seq_len)
        self.prefill_batch_sizes = ip["prefill_batch_sizes"] or \
            [b for b in (1, 2, 4) if b <= self.max_batch_size]
        self.decode_batch_sizes = ip["decode_batch_sizes"] or \
            _pow2_ladder(1, self.max_batch_size)

        # -- params --------------------------------------------------------
        if params is None:
            params = dict(model.named_parameters())
        # compute dtype comes from a matmul WEIGHT: 1-D leaves (biases,
        # norms) rest in fp32 (`prepare_inference_params`)
        leaves = list(params.values())
        self.compute_dtype = next(
            (t.dtype for t in leaves if t.dim() >= 2), leaves[0].dtype)
        kv_dtype = ip["kv_cache_dtype"]
        self.kv_cache_dtype = (resolve_kv_cache_dtype(kv_dtype)
                               if kv_dtype else self.compute_dtype)
        self.kv_quant = self.kv_cache_dtype == torch.int8
        # int8 block matmul weights at rest (the "quantization" block's
        # weights choice); inference.kernel reaches their matmuls as the
        # backend `_prefill` / `_decode` hand to the block functions
        self.weight_quant = (quantization or {}).get("weights")
        self.params = neox.unflatten(prepare_inference_params(
            params, self.compute_dtype, weight_quant=self.weight_quant,
            device=self.device))

        # -- cache / scheduler ---------------------------------------------
        self.family = _Family(model, self.max_seq_len, self.device)
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_pages=ip["num_pages"],
            num_heads=cfg.num_heads, page_size=self.page_size,
            head_dim=cfg.head_dim, dtype=self.kv_cache_dtype,
            device=self.device)
        self.scheduler = ContinuousBatchingScheduler(
            self.cache, max_seq_len=self.max_seq_len,
            token_budget=ip["token_budget"],
            max_batch_size=self.max_batch_size,
            prefill_lengths=self.prefill_lengths,
            prefill_batch_sizes=self.prefill_batch_sizes,
            decode_batch_sizes=self.decode_batch_sizes)
        self.n_pages_max = pages_for_tokens(self.max_seq_len,
                                            self.page_size)
        self.dtypes = {"weight": self.weight_quant or str(self.compute_dtype),
                       "compute": str(self.compute_dtype),
                       "kv_cache": ("int8" if self.kv_quant
                                    else str(self.kv_cache_dtype))}
        self.default_priority = ip["default_priority"]
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.seed)
        self.stats = {"steps": 0, "prefill_requests": 0,
                      "prefill_tokens": 0, "decode_tokens": 0,
                      "evictions": 0, "finished": 0,
                      "schedule_s": 0.0, "prefill_s": 0.0,
                      "decode_s": 0.0, "admission_wait_s": 0.0,
                      "queue_depth": 0.0, "page_pool_util": 0.0,
                      "requests_ok": 0, "requests_deadline_exceeded": 0,
                      "requests_failed": 0}
        self.request_metrics = ServeRequestMetrics()

    @staticmethod
    def _reject_unported(d, ip):
        """Every serving feature this slice does not carry raises here,
        before anything is allocated."""
        checks = (
            (ip["prefix_cache"] is not None, "inference.prefix_cache",
             "serving"),
            (ip["speculative"] is not None, "inference.speculative",
             "serving"),
            (ip["disaggregation"]["role"] != "unified",
             "an inference.disaggregation role other than \"unified\"",
             "serving"),
            (ip["router"] is not None, "inference.router", "serving"),
            (ip["fault_injection"] is not None,
             "inference.fault_injection", "robustness"),
            (ip["admission"] is not None, "inference.admission",
             "robustness"),
            (ip["hang_timeout_s"] > 0, "inference.hang_timeout_s > 0",
             "robustness"),
        )
        for hit, what, slice_name in checks:
            if hit:
                raise _not_ported(what, slice_name)
        telemetry = d.get("telemetry")
        if isinstance(telemetry, dict) and telemetry.get("enabled", True):
            raise _not_ported("telemetry spans", "observability")

    # ------------------------------------------------------------------
    # the device programs
    # ------------------------------------------------------------------

    def _sample(self, logits):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._generator)[:, 0]

    def _attention(self, q, k_pages, v_pages, page_table, lengths):
        """Paged decode attention; int8 pools arrive as `QuantizedPages`
        and hand their scale pools to the int8 kernel."""
        scales = {}
        if isinstance(k_pages, QuantizedPages):
            scales = {"k_scales": k_pages.scale, "v_scales": v_pages.scale}
            k_pages, v_pages = k_pages.data, v_pages.data
        return paged_decode_attention(q, k_pages, v_pages, page_table,
                                      lengths, backend=self._attn_backend,
                                      **scales)

    @torch.no_grad()
    def _prefill(self, tokens, lengths, page_table):
        """tokens [B, S], lengths [B], page_table [B, S/ps] (device) →
        sampled first tokens [B]; writes every row's K/V pages."""
        cfg = self.model.config
        fam = self.family
        params = self.params
        B, S = tokens.shape
        ps = self.page_size
        H, D = cfg.num_heads, cfg.head_dim
        n_pages_row = S // ps
        cos, sin, rot_dim = fam.cos_sin_prefill(S)
        pos = torch.arange(S, device=self.device)[None, :]
        # 1 = real token, 0 = pad: the segmented attention then gives each
        # row causal attention over its own tokens only
        seg = (pos < lengths[:, None]).to(torch.int32)
        flat_pt = page_table.reshape(-1).long()
        x = fam.embed(params, tokens, pos)
        backend = self._attn_backend
        for layer, bp in enumerate(params["blocks"]):
            q, k, v = neox._block_qkv(cfg, bp, x, cos, sin, rot_dim, H,
                                      backend=backend)
            attn = neox.causal_attention(
                q, k, v, use_kernels=self.model.use_kernels,
                segment_ids=seg)
            x = neox._block_post_attn(cfg, bp, x, attn.reshape(B, S, H * D),
                                      backend=backend)
            # whole-page scatter: [B, S, H, D] → B·S/ps page tiles at the
            # page-table ids (pad rows hold table id 0, the trash page,
            # so duplicates only ever collide there)
            for pool, new in ((self.cache.k[layer], k),
                              (self.cache.v[layer], v)):
                tiles = new.reshape(B, n_pages_row, ps, H, D)
                tiles = tiles.transpose(2, 3).reshape(B * n_pages_row, H,
                                                      ps, D)
                if isinstance(pool, QuantizedPages):
                    # int8 pages: quantize each (head, slot) vector and
                    # scatter data and scale through the same page ids
                    q8, sc = quantize_kv(tiles)
                    pool.data[flat_pt] = q8
                    pool.scale[flat_pt] = sc.to(pool.scale.dtype)
                else:
                    pool[flat_pt] = tiles.to(pool.dtype)
        idx = (lengths.long() - 1).clamp(0, S - 1)
        h_last = x[torch.arange(B, device=self.device), idx]
        h_last = neox.layer_norm(h_last, params["final_ln"]["scale"],
                                 params["final_ln"]["bias"],
                                 cfg.layernorm_eps)
        return self._sample(fam.head(params, h_last))

    @torch.no_grad()
    def _decode(self, tokens, lengths, page_table):
        """tokens [B], lengths [B] (including this token; 0 = inactive
        row), page_table [B, NP] (device) → sampled tokens [B]."""
        cfg = self.model.config
        fam = self.family
        params = self.params
        ps = self.page_size
        H, D = cfg.num_heads, cfg.head_dim
        B = tokens.shape[0]
        pos = (lengths.long() - 1).clamp(min=0)
        x = fam.embed(params, tokens, pos)[:, None, :]
        cos, sin, rot_dim = fam.cos_sin_decode(pos)
        page_idx = page_table.gather(1, (pos // ps)[:, None])[:, 0].long()
        slot = pos % ps
        backend = self._attn_backend
        for layer, bp in enumerate(params["blocks"]):
            q, k, v = neox._block_qkv(cfg, bp, x, cos, sin, rot_dim, H,
                                      backend=backend)
            k_pool, v_pool = self.cache.k[layer], self.cache.v[layer]
            # one decoded token's K and V row into its page slot; int8
            # pools quantize per head vector and land the scale in the
            # page-aligned scale pool
            for pool, vec in ((k_pool, k[:, 0]), (v_pool, v[:, 0])):
                if isinstance(pool, QuantizedPages):
                    q8, sc = quantize_kv(vec)
                    pool.data[page_idx, :, slot] = q8
                    pool.scale[page_idx, :, slot] = sc.to(pool.scale.dtype)
                else:
                    pool[page_idx, :, slot] = vec.to(pool.dtype)
            # the int8 kernel reads q in the compute dtype
            qrow = q[:, 0] if self.kv_quant else q[:, 0].to(k_pool.dtype)
            attn = self._attention(qrow, k_pool, v_pool, page_table, lengths)
            x = neox._block_post_attn(cfg, bp, x,
                                      attn.to(x.dtype).reshape(B, 1, H * D),
                                      backend=backend)
        h = neox.layer_norm(x[:, 0], params["final_ln"]["scale"],
                            params["final_ln"]["bias"], cfg.layernorm_eps)
        return self._sample(fam.head(params, h))

    def _to_device(self, arr):
        return torch.from_numpy(arr).to(self.device)

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens, eos_token_id=None,
               request_id=None, priority=None, deadline_ms=None):
        """Enqueue one request; returns its id. ``priority`` is a class
        name (``interactive``/``batch``: eviction takes ``batch`` first);
        ``deadline_ms`` bounds the request's total wall clock (expired
        requests end with status ``deadline_exceeded``)."""
        priority = self.default_priority if priority is None else priority
        validate_priority(priority)
        if deadline_ms is not None and (
                not isinstance(deadline_ms, (int, float)) or
                isinstance(deadline_ms, bool) or deadline_ms <= 0):
            raise ValueError(f"deadline_ms must be a number > 0 "
                             f"(milliseconds), got {deadline_ms!r}")
        req = Request(prompt=[int(t) for t in prompt],
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id, request_id=request_id,
                      priority=priority,
                      deadline_ms=(None if deadline_ms is None
                                   else float(deadline_ms)))
        return self.scheduler.add_request(req, now=time.perf_counter())

    def step(self):
        """One scheduler step: admit + prefill new requests, decode one
        token for every in-flight sequence. Returns a summary dict. A
        prefill or decode exception propagates."""
        now = time.perf_counter()
        finished_before = len(self.scheduler.finished)
        plan = self.scheduler.schedule(now=now)
        self.stats["schedule_s"] += time.perf_counter() - now
        self.stats["evictions"] += len(plan.evicted)
        for req in plan.prefills:
            if req.admitted_at is not None and req.enqueued_at is not None:
                wait = req.admitted_at - req.enqueued_at
                self.stats["admission_wait_s"] += wait
                self.request_metrics.observe_admission_wait(wait)
        usable = max(self.cache.num_pages - 1, 1)
        self.stats["queue_depth"] = float(len(self.scheduler.waiting))
        self.stats["page_pool_util"] = 1.0 - self.cache.num_free / usable

        if plan.prefills:
            t0 = time.perf_counter()
            self._run_prefill(plan)
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefill_requests"] += len(plan.prefills)
            # r.cached is the pre-sampling context length (complete_
            # prefill pins it before appending the first token)
            self.stats["prefill_tokens"] += \
                sum(r.cached for r in plan.prefills)

        produced = 0
        if plan.decodes and all(r.state == RUNNING for r in plan.decodes):
            t0 = time.perf_counter()
            produced = self._run_decode(plan)
            self.stats["decode_s"] += time.perf_counter() - t0
            self.stats["decode_tokens"] += produced

        finished = len(self.scheduler.finished) - finished_before
        self.stats["finished"] += finished
        self.stats["steps"] += 1
        sc = self.scheduler.status_counts
        self.stats["requests_ok"] = sc["ok"]
        self.stats["requests_deadline_exceeded"] = sc["deadline_exceeded"]
        self.stats["requests_failed"] = sc["failed"]
        return {"prefilled": len(plan.prefills), "decoded": produced,
                "evicted": len(plan.evicted), "finished": finished}

    def _complete_prefills(self, reqs, nxt):
        now = time.perf_counter()
        for i, req in enumerate(reqs):
            self.scheduler.complete_prefill(req, int(nxt[i]))
            # TTFT: once per request, from the ORIGINAL submit — an
            # evicted request's re-prefill must not re-count
            if req.first_token_at is None and req.submitted_at is not None:
                req.first_token_at = now
                self.request_metrics.observe_ttft(now - req.submitted_at)
            req.last_token_at = now

    def _run_prefill(self, plan):
        B, S = plan.prefill_batch, plan.prefill_len
        n_pages_row = S // self.page_size
        tokens = np.zeros((B, S), np.int64)
        lengths = np.zeros((B,), np.int32)
        page_table = np.zeros((B, n_pages_row), np.int32)
        for i, req in enumerate(plan.prefills):
            ctx = req.context
            tokens[i, :len(ctx)] = ctx
            lengths[i] = len(ctx)
            page_table[i, :len(req.pages)] = req.pages
        nxt = self._prefill(self._to_device(tokens),
                            self._to_device(lengths),
                            self._to_device(page_table))
        self._complete_prefills(plan.prefills, nxt.cpu().numpy())

    def _run_decode(self, plan):
        B = plan.decode_batch
        tokens = np.zeros((B,), np.int64)
        lengths = np.zeros((B,), np.int32)
        page_table = np.zeros((B, self.n_pages_max), np.int32)
        for i, req in enumerate(plan.decodes):
            tokens[i] = req.generated[-1]
            lengths[i] = req.cached + 1
            page_table[i, :len(req.pages)] = req.pages
        nxt = self._decode(self._to_device(tokens), self._to_device(lengths),
                           self._to_device(page_table)).cpu().numpy()
        now = time.perf_counter()
        for i, req in enumerate(plan.decodes):
            self.scheduler.complete_decode(req, int(nxt[i]))
            if req.last_token_at is not None:
                self.request_metrics.observe_inter_token(
                    now - req.last_token_at)
            req.last_token_at = now
        return len(plan.decodes)

    def run(self, max_steps=None):
        """Drive steps until the queue drains (or `max_steps`)."""
        steps = 0
        while self.scheduler.has_work:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    def generate(self, prompts, max_new_tokens, eos_token_id=None):
        """Batch convenience: submit every prompt, drain the queue, and
        return the generated token lists in submission order. Consumes
        `scheduler.pop_finished()`, so the finished list cannot grow
        across repeated calls."""
        ids = [self.submit(p, max_new_tokens, eos_token_id=eos_token_id)
               for p in prompts]
        done = {}
        while self.scheduler.has_work:
            self.step()
            for r in self.scheduler.pop_finished():
                done[r.request_id] = r
        return [list(done[i].generated) for i in ids]

    def serve_stats(self):
        """Counters + phase seconds + request-latency percentiles (p50/p99
        of admission wait / TTFT / inter-token, from the fixed-bucket
        histograms)."""
        out = dict(self.stats)
        out.update(self.request_metrics.summary())
        return out
