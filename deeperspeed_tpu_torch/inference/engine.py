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
  compile here. `compile_count()` counts the distinct bucket programs
  that have run, so a warm stream adds none, as in the JAX package.
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
- **Prefix cache** (``inference.prefix_cache``). A `PrefixCache` over
  the allocator registers every prefilled prompt's full pages. A request
  whose prompt starts with a registered chain shares those pages and
  prefills only its suffix through the chunk program (`_chunk`): the
  window at its absolute positions stores its K/V into the request's
  own pages, then attends over the whole page table in plain PyTorch,
  the JAX package's XLA code. A prefix-hit batch never takes the
  whole-page scatter of `_prefill`, which would overwrite shared pages.
- **Speculative decoding** (``inference.speculative`` with
  ``draft_model=``). The draft keeps shadow pools at the target's page
  ids. Every prefill also writes the draft's K/V (the chunk program's
  draft duty); each decode step the draft proposes k tokens in k + 1
  paged decode steps (`_propose`), the target verifies the window in one
  chunk call, and acceptance appends 1 to k + 1 tokens a row. Greedy
  acceptance is token-identical to plain decode; sampled acceptance is
  rejection sampling on a numpy generator of its own.
- **Serving under failure.** ``inference.admission`` sheds a request at
  `submit` with a typed `RequestRejected` (a full queue, page-pool or
  TTFT pressure, an SLO the measured TTFT already misses). A prefill or
  decode exception QUARANTINES the batch (`_quarantine_batch`): the
  requests free their pages and re-prefill from their full context after
  a capped, jittered backoff (``inference.retry``, `utils.kv_retry`), and
  a request that fails ``retry.max_attempts`` steps in a row ends with a
  typed `RequestFailed`; the server stays up. ``inference.fault_injection``
  (or ``DS_FAULT_INJECT``) scripts prefill / decode errors, decode stalls
  and page-pool pressure by step serial. ``inference.hang_timeout_s``
  arms a `runtime.sentinel.HangWatchdog` around a step whose bucket
  programs have all run before (a first call builds the kernels and the
  cuBLAS state: it is not a hang); on expiry it dumps every thread's
  stack and requests a drain. `drain` stops admissions, finishes what is
  in flight within ``inference.drain_deadline_s`` and fails the rest
  with a typed `DrainAborted`; `install_drain_handler` makes SIGTERM /
  SIGINT request it, and `run` then drains and exits with code 0.

Sampling is deterministic: temperature 0 (default) is argmax;
temperature > 0 draws from the softmax with the engine's
`torch.Generator`, re-seeded from (config seed, program count) before
each sampling program as the JAX package folds its step counter into
its key (`sampler_state` / `restore_sampler_state` carry the count and
the speculative generator's state). The draws are the port's own, not
the JAX package's.

Observability: a "telemetry" block spans each step's ``schedule``,
``prefill`` and ``decode`` (mirrored into `torch.profiler`
record_functions), and a ``monitor=`` (a `runtime.monitor.
TensorBoardMonitor`) receives the per-step ``Serve/*`` saturation
scalars keyed by total generated tokens and, through
`ServeRequestMetrics`, every admission-wait / TTFT / inter-token
observation for its Prometheus histograms. `drain` pushes the final
``Serve/*`` counters, then closes an owned monitor (``owns_monitor``) or
flushes a borrowed one, then closes the telemetry.

Not ported yet (each raises at construction, and ROADMAP.md lists it):
disaggregated roles, the router and a model-parallel mesh (scale-out).
"""

import random
import time
import types

import numpy as np
import torch

from ..models import gpt2 as gpt2_mod
from ..models import gpt_neox as neox
from ..module_inject.replace_module import prepare_inference_params
from ..ops.hopper.decode_attention import (paged_attention_reference,
                                           paged_decode_attention)
from ..runtime.config import (DeepSpeedConfig, parse_inference_block,
                              parse_quantization_block)
from ..runtime.config_utils import DeepSpeedConfigError, load_config_json
from ..runtime.fault_injection import (FaultInjector, InjectedServingFault,
                                       SERVING_FAULT_KINDS)
from ..runtime.precision import resolve_kv_cache_dtype
from ..utils.device import resolve_device
from ..utils.kv_retry import backoff_delay
from ..utils.logging import logger
from .admission import (AdmissionController, DrainAborted, RequestFailed,
                        validate_priority)
from .kv_cache import (PagedKVCache, PrefixCache, QuantizedPages,
                       pages_for_tokens, quantize_kv)
from .metrics import (PREFIX_HIT_RATE, PREFIX_PAGES_SHARED,
                      PREFIX_SAVED_PREFILL_TOKENS, REQUEST_STATUS_FAMILIES,
                      SPEC_ACCEPTANCE_RATE, ServeRequestMetrics)
from .scheduler import (FINISHED, RUNNING, ContinuousBatchingScheduler,
                        Request)


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


def sampling_seed(seed, steps):
    """The generator seed of sampling program ``steps``: (seed, steps)
    packed into one 64-bit seed, the port's `jax.random.fold_in`."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(steps) & 0xFFFFFFFF)


def _store(pool, page_idx, slot, vec):
    """K or V rows ``vec`` [..., H, D] into their (page, slot) cells
    (``page_idx`` / ``slot`` of vec's leading shape); int8 pools quantize
    each (head, token) vector with the same `quantize_kv` as every other
    write path, so identical tokens give identical page bytes."""
    if isinstance(pool, QuantizedPages):
        q8, sc = quantize_kv(vec)
        pool.data[page_idx, :, slot] = q8
        pool.scale[page_idx, :, slot] = sc.to(pool.scale.dtype)
    else:
        pool[page_idx, :, slot] = vec.to(pool.dtype)


def _pool_args(k_pool, v_pool):
    """(k, v, scale kwargs) of one layer's pools for the paged attention:
    int8 pools arrive as `QuantizedPages` and hand on their scale
    pools."""
    if isinstance(k_pool, QuantizedPages):
        return k_pool.data, v_pool.data, {"k_scales": k_pool.scale,
                                          "v_scales": v_pool.scale}
    return k_pool, v_pool, {}


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
        to tokens: [1, S] in a prefill, [B] in a decode step, [B, S] in
        a chunk window) → [..., H]; GPT-2 adds its ``wpe`` rows there."""
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

    def cos_sin_at(self, positions):
        """Per-token rotary rows at `positions` [B, S] → ([B, S, rot],
        ...): a chunk window starting mid-sequence."""
        return self._cos[positions], self._sin[positions], self.rot_dim

    def set_head(self, params):
        """Keep the LM head's weight of ``params`` (``embed_out``, else
        the tied ``wte``) widened to fp32, once a set of weights: it is
        read-only, and `head` reads it every program."""
        self._head_w = params.get("embed_out",
                                  params["embed"])["wte"].float()

    def head(self, h):
        """Final-norm hidden [..., H] → logits [..., V] (fp32): one row
        a sequence, or every window position (the speculative verify).
        The products of h and the head weight (both in the compute dtype,
        so exact in fp32) are summed in fp32 and never rounded to the
        compute dtype (the JAX head's ``preferred_element_type=float32``):
        bf16 logits would tie in the argmax where the JAX package's do
        not."""
        return h.float() @ self._head_w.t()


class InferenceEngine:
    """Continuous-batching serving over the paged KV cache.

    ``model`` is a `models.gpt_neox.GPTNeoX` or a `models.gpt2.GPT2`;
    ``config`` a dict or JSON
    path holding the ``"inference"`` block; ``params`` an optional
    ``{dotted name: tensor}`` state dict (else the model's own
    parameters). ``draft_model`` (GPT-NeoX or GPT-2, the target's
    vocabulary and at least its window) and its optional
    ``draft_params`` serve ``inference.speculative``. ``device``
    defaults to ``"cuda"`` and raises when CUDA is absent; the CPU must
    be asked for (``device="cpu"``). ``monitor`` (a
    `runtime.monitor.TensorBoardMonitor`) receives the ``Serve/*``
    scalars and histograms; ``owns_monitor=False`` keeps `drain` from
    closing it (a monitor borrowed from a training engine).
    """

    def __init__(self, model, config=None, params=None, device=None,
                 mesh=None, draft_model=None, draft_params=None,
                 monitor=None, owns_monitor=True):
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
        # the training parser's telemetry validation, without the batch
        # triad it also wants
        ns = types.SimpleNamespace()
        DeepSpeedConfig._parse_telemetry_block(ns, d)
        telemetry_config = ns.telemetry_config
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
        # backend the programs hand to the block functions
        self.weight_quant = (quantization or {}).get("weights")
        # the natural names a checkpoint load or a weight swap must carry
        self._natural_names = list(params)
        self.prefix_cache = None
        self.family = _Family(model, self.max_seq_len, self.device)
        self._set_params(self._prepare(params, self.weight_quant))

        # -- cache / scheduler ---------------------------------------------
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_pages=ip["num_pages"],
            num_heads=cfg.num_heads, page_size=self.page_size,
            head_dim=cfg.head_dim, dtype=self.kv_cache_dtype,
            device=self.device)
        # -- prefix registry + speculative decoding (both off without
        #    their config sub-blocks: the plain serving loop) ------------
        if ip["prefix_cache"] is not None:
            self.prefix_cache = PrefixCache(
                self.cache, max_pages=ip["prefix_cache"]["max_pages"])
        self.spec_k = 0
        self.draft_model = None
        self.draft_cache = None
        if ip["speculative"] is not None:
            self._init_draft(ip, draft_model, draft_params)
        self.scheduler = ContinuousBatchingScheduler(
            self.cache, max_seq_len=self.max_seq_len,
            token_budget=ip["token_budget"],
            max_batch_size=self.max_batch_size,
            prefill_lengths=self.prefill_lengths,
            prefill_batch_sizes=self.prefill_batch_sizes,
            decode_batch_sizes=self.decode_batch_sizes,
            prefix_cache=self.prefix_cache, spec_tokens=self.spec_k)
        self.n_pages_max = pages_for_tokens(self.max_seq_len,
                                            self.page_size)
        self.dtypes = {"weight": self.weight_quant or str(self.compute_dtype),
                       "compute": str(self.compute_dtype),
                       "kv_cache": ("int8" if self.kv_quant
                                    else str(self.kv_cache_dtype))}
        self.default_priority = ip["default_priority"]
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.seed)
        self._steps = 0
        # calls of each bucket program, by (duty, shape) key
        self.program_calls = {}
        self.stats = {"steps": 0, "prefill_requests": 0,
                      "prefill_tokens": 0, "decode_tokens": 0,
                      "evictions": 0, "finished": 0,
                      "schedule_s": 0.0, "prefill_s": 0.0,
                      "decode_s": 0.0, "admission_wait_s": 0.0,
                      "queue_depth": 0.0, "page_pool_util": 0.0,
                      # terminal-status taxonomy: every request reaches
                      # exactly one
                      "requests_ok": 0, "requests_shed": 0,
                      "requests_deadline_exceeded": 0,
                      "requests_failed": 0,
                      "quarantines": 0, "retries": 0,
                      # speculative decoding: proposed / accepted draft
                      # tokens and verify steps (0 with speculation off)
                      "spec_steps": 0, "spec_proposed": 0,
                      "spec_accepted": 0}
        # telemetry (spans: schedule / prefill / decode) and the monitor.
        # A BORROWED monitor (owns_monitor=False, e.g. a co-located
        # training engine's) is flushed by drain() but not closed
        from ..runtime.telemetry import build_telemetry
        self.monitor = monitor
        self._owns_monitor = bool(owns_monitor)
        self.telemetry = build_telemetry(telemetry_config, monitor=monitor,
                                         devices=[self.device])
        # request-level latency histograms, fanned out to the monitor's
        # export backends (Prometheus histogram families)
        self.request_metrics = ServeRequestMetrics(monitor=monitor)

        # graceful drain (SIGTERM): a flag-only handler, acted on at the
        # next serving-loop iteration
        self.drain_deadline_s = ip["drain_deadline_s"]
        self._drain_requested = False
        self._prev_handlers = {}
        # -- robustness: admission control, the retry / poison policy,
        #    serving fault injection, the hang watchdog ------------------
        self.retry_params = ip["retry"]
        self._retry_rng = random.Random(ip["seed"])
        self.admission = (AdmissionController(ip["admission"])
                          if ip["admission"] else None)
        self.fault_injector = FaultInjector.from_config_env(
            config_spec=ip["fault_injection"])
        self._step_faults = []      # serving faults fired this step
        self._pressure_pages = []   # page_pool_pressure seizures
        self.watchdog = None
        self.watchdog_fires = 0
        self.last_stack_dump = None
        if ip["hang_timeout_s"] > 0:
            from ..runtime.sentinel import HangWatchdog
            self.watchdog = HangWatchdog(ip["hang_timeout_s"], self,
                                         "_on_serving_hang")

    def _init_draft(self, ip, draft_model, draft_params):
        """The draft model of ``inference.speculative``: the JAX engine's
        checks, its params prepared at the target's compute dtype (int8
        block weights under ``draft_weight_quant``), and its shadow pools
        at the target's num_pages / page_size, so that one page id
        addresses a sequence's K/V in both models and no second
        allocator exists."""
        sp = ip["speculative"]
        cfg = self.model.config
        if draft_model is None:
            raise DeepSpeedConfigError(
                "inference.speculative is enabled but no draft_model "
                "was passed to InferenceEngine (the draft proposes "
                "the tokens the target verifies)")
        dcfg = draft_model.config
        if getattr(dcfg, "moe_num_experts", 0):
            raise DeepSpeedConfigError(
                "an MoE draft model is not supported (the decode "
                "block would silently drop the expert routing)")
        if dcfg.vocab_size != cfg.vocab_size:
            raise DeepSpeedConfigError(
                f"draft vocab_size {dcfg.vocab_size} != target "
                f"vocab_size {cfg.vocab_size}: draft proposals would "
                f"index a different token space")
        if dcfg.max_seq_len < self.max_seq_len:
            raise DeepSpeedConfigError(
                f"draft max_seq_len {dcfg.max_seq_len} is smaller "
                f"than the serving window {self.max_seq_len}: the "
                f"draft could not reach every decode position")
        self.spec_k = sp["num_draft_tokens"]
        self.draft_model = draft_model
        if draft_params is None:
            draft_params = dict(draft_model.named_parameters())
        self.draft_params = neox.unflatten(
            self._prepare(draft_params, sp["draft_weight_quant"]))
        self.draft_family = _Family(draft_model, self.max_seq_len,
                                    self.device)
        self.draft_family.set_head(self.draft_params)
        self.draft_cache = PagedKVCache(
            num_layers=dcfg.num_layers, num_pages=ip["num_pages"],
            num_heads=dcfg.num_heads, page_size=self.page_size,
            head_dim=dcfg.head_dim, dtype=self.kv_cache_dtype,
            device=self.device)
        # host-side rejection sampling (temperature > 0): its own
        # deterministic stream, apart from the sampling generator
        self._spec_rng = np.random.default_rng(self.seed)

    @staticmethod
    def _reject_unported(d, ip):
        """Every serving feature this port does not carry yet raises
        here, before anything is allocated."""
        checks = (
            (ip["disaggregation"]["role"] != "unified",
             "an inference.disaggregation role other than \"unified\"",
             "scale-out"),
            (ip["router"] is not None, "inference.router", "scale-out"),
        )
        for hit, what, slice_name in checks:
            if hit:
                raise _not_ported(what, slice_name)

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------

    def _prepare(self, params, weight_quant):
        return prepare_inference_params(
            params, self.compute_dtype, weight_quant=weight_quant,
            device=self.device)

    def _set_params(self, params):
        """Install prepared ``{name: tensor}`` params. A weight swap
        invalidates every registered prefix page (its K/V is a function
        of the old weights): the registry is dropped and waiting
        requests detach their prefixes; running requests keep decoding
        on their old-weights K/V, as in the JAX package."""
        self.params = neox.unflatten(params)
        self.family.set_head(self.params)
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
            self.scheduler.detach_waiting_prefixes()

    def load_checkpoint(self, load_dir, tag=None):
        """Params-only restore through the manifest-verified loader
        (`checkpoint.checkpointing.load_module_checkpoint`: CRC checks
        and the committed-tag fallback, no optimizer state read), from
        a checkpoint the JAX package or the port wrote. Returns (path,
        client_state), or (None, {}) when there is none."""
        from ..checkpoint.checkpointing import load_module_checkpoint
        path, natural, client_state = load_module_checkpoint(
            load_dir, tag=tag, like=self._natural_names)
        if path is None:
            return None, {}
        self._set_params(self._prepare(natural, self.weight_quant))
        return path, client_state

    def hot_swap_weights(self, natural_params):
        """In-process weight swap: ``natural_params`` is a ``{dotted
        name: tensor}`` state dict of the target (what ``params=``
        takes), cast or int8-quantized as at construction. Eager
        programs take the params as they run, so nothing is rebuilt.
        Returns ``{"swap_ms", "compile_delta"}``."""
        before = self.compile_count()
        t0 = time.perf_counter()
        self._set_params(self._prepare(natural_params, self.weight_quant))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"swap_ms": (time.perf_counter() - t0) * 1e3,
                "compile_delta": self.compile_count() - before}

    def sampler_state(self):
        """Snapshot of every sampling stream: the program counter the
        sampling generator is re-seeded from and, with speculation, the
        rejection sampler's PCG64 state (plain data, as in the JAX
        package)."""
        state = {"steps": int(self._steps)}
        if self.spec_k:
            state["spec_rng"] = self._spec_rng.bit_generator.state
        return state

    def restore_sampler_state(self, state):
        """Restore `sampler_state()`: sampling is a function of (seed,
        steps), so a restored engine draws the tokens an uninterrupted
        one would have drawn."""
        self._steps = int(state["steps"])
        if self.spec_k and "spec_rng" in state:
            self._spec_rng.bit_generator.state = state["spec_rng"]

    def compile_count(self):
        """The distinct bucket programs that have run, by (duty, shape):
        what the JAX engine's count of compiled executables counts, so a
        warm stream adds none."""
        return len(self.program_calls)

    def _program(self, *key):
        self.program_calls[key] = self.program_calls.get(key, 0) + 1

    # ------------------------------------------------------------------
    # the device programs
    # ------------------------------------------------------------------

    def _next_rng(self):
        """The sampling generator of the next program, re-seeded from
        (seed, program count)."""
        self._steps += 1
        return self._generator.manual_seed(sampling_seed(self.seed,
                                                         self._steps))

    def _sample(self, logits, rng):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=rng)[:, 0]

    def _side(self, which):
        """(model config, family, params, cache) of the target or the
        draft."""
        if which == "target":
            return self.model.config, self.family, self.params, self.cache
        return (self.draft_model.config, self.draft_family,
                self.draft_params, self.draft_cache)

    def _attention(self, q, k_pages, v_pages, page_table, lengths):
        """Paged decode attention; int8 pools hand their scale pools to
        the int8 kernel."""
        k_pages, v_pages, scales = _pool_args(k_pages, v_pages)
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
        return self._sample(fam.head(h_last), self._next_rng())

    def _decode_blocks(self, which, tokens, pos, page_idx, page_table,
                       att_len):
        """One token a row through every block of the target or the
        draft: its K/V stored at (``page_idx``, ``pos % ps``) before the
        paged decode attends over ``page_table`` up to ``att_len`` →
        the final-norm hidden [B, h]."""
        cfg, fam, params, cache = self._side(which)
        H, D = cfg.num_heads, cfg.head_dim
        B = tokens.shape[0]
        x = fam.embed(params, tokens, pos)[:, None, :]
        cos, sin, rot_dim = fam.cos_sin_decode(pos)
        slot = pos % self.page_size
        backend = self._attn_backend
        for layer, bp in enumerate(params["blocks"]):
            q, k, v = neox._block_qkv(cfg, bp, x, cos, sin, rot_dim, H,
                                      backend=backend)
            k_pool, v_pool = cache.k[layer], cache.v[layer]
            _store(k_pool, page_idx, slot, k[:, 0])
            _store(v_pool, page_idx, slot, v[:, 0])
            # the int8 kernel reads q in the compute dtype
            qrow = q[:, 0] if self.kv_quant else q[:, 0].to(k_pool.dtype)
            attn = self._attention(qrow, k_pool, v_pool, page_table, att_len)
            x = neox._block_post_attn(cfg, bp, x,
                                      attn.to(x.dtype).reshape(B, 1, H * D),
                                      backend=backend)
        return neox.layer_norm(x[:, 0], params["final_ln"]["scale"],
                               params["final_ln"]["bias"], cfg.layernorm_eps)

    @torch.no_grad()
    def _decode(self, tokens, lengths, page_table):
        """tokens [B], lengths [B] (including this token; 0 = inactive
        row), page_table [B, NP] (device) → sampled tokens [B]."""
        pos = (lengths.long() - 1).clamp(min=0)
        page_idx = page_table.gather(
            1, (pos // self.page_size)[:, None])[:, 0].long()
        h = self._decode_blocks("target", tokens, pos, page_idx, page_table,
                                lengths)
        return self._sample(self.family.head(h),
                            self._next_rng())

    @torch.no_grad()
    def _chunk(self, which, mode, tokens, start, n_new, page_table):
        """The mid-sequence window program: ``tokens`` [B, S] at per-row
        absolute positions ``start + 0..S-1`` (``n_new`` valid), their
        K/V written into the row's pages BEFORE the window attends over
        the whole page table (earlier positions included: a
        continuation, not a fresh prefill). One program, three duties:

        - ``("target", "sample")``: a prefix hit's suffix prefill; the
          first token samples at the last valid position → [B];
        - ``("target", "verify")``: the speculative verify over [pending
          token, k proposals] → per-position argmax tokens [B, S]
          (greedy) or fp32 next-token probabilities [B, S, V] (sampled);
        - ``("draft", "write")``: the draft's twin of any prefill (full
          or suffix): its K/V only, no head → None.

        Invalid window slots write to the trash page 0 (their duplicate
        indices only ever collide there, and page 0 is never read
        unmasked). The attention is the plain `paged_attention_reference`
        over the row-gathered pages (XLA code in the JAX package too)."""
        cfg, fam, params, cache = self._side(which)
        B, S = tokens.shape
        ps = self.page_size
        H = cfg.num_heads
        offs = torch.arange(S, device=self.device)[None, :]
        valid = offs < n_new[:, None]
        pos = (start.long()[:, None] + offs).clamp(0, self.max_seq_len - 1)
        x = fam.embed(params, tokens, pos)
        cos, sin, rot_dim = fam.cos_sin_at(pos)
        page_idx = page_table.gather(1, pos // ps).long()
        page_idx = torch.where(valid, page_idx, torch.zeros_like(page_idx))
        slot = pos % ps
        # query position p sees cache slots 0..p; invalid rows see none
        qpos = torch.where(valid, pos, torch.full_like(pos, -1))
        backend = self._attn_backend
        for layer, bp in enumerate(params["blocks"]):
            q, k, v = neox._block_qkv(cfg, bp, x, cos, sin, rot_dim, H,
                                      backend=backend)
            k_pool, v_pool = cache.k[layer], cache.v[layer]
            _store(k_pool, page_idx, slot, k)
            _store(v_pool, page_idx, slot, v)
            kp, vp, scales = _pool_args(k_pool, v_pool)
            # q rounds to the pool dtype, as in JAX (int8 pools: the
            # compute dtype)
            qw = q if self.kv_quant else q.to(kp.dtype)
            attn = paged_attention_reference(qw, kp, vp, page_table, qpos,
                                             **scales)
            x = neox._block_post_attn(cfg, bp, x,
                                      attn.to(x.dtype).reshape(B, S, -1),
                                      backend=backend)
        if mode == "write":
            return None
        final = params["final_ln"]
        if mode == "sample":
            idx = (n_new.long() - 1).clamp(0, S - 1)
            h = x[torch.arange(B, device=self.device), idx]
            h = neox.layer_norm(h, final["scale"], final["bias"],
                                cfg.layernorm_eps)
            return self._sample(fam.head(h), self._next_rng())
        h = neox.layer_norm(x, final["scale"], final["bias"],
                            cfg.layernorm_eps)
        logits = fam.head(h)
        # the verify takes a sampling program's slot, as in the JAX
        # engine, though acceptance samples on the host
        self._next_rng()
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        return torch.softmax(logits / self.temperature, dim=-1)

    @torch.no_grad()
    def _propose(self, tokens, lengths, windows, page_table):
        """The draft program: k + 1 decode steps through the draft
        against its pools (the target's page ids). Steps 0..k-1 propose
        the argmax; the last writes the final proposal's K/V without
        sampling, so the draft cache covers every token the target may
        accept. A row's ``windows`` gate its writes and attention past
        its speculative window to the trash page (a row at its
        max_new_tokens edge, window 0, still gets its pending token's
        draft K/V written and nothing else) → proposals [B, k]."""
        base = (lengths.long() - 1).clamp(min=0)
        live = lengths > 0
        proposed = []
        tok = tokens
        for j in range(self.spec_k + 1):
            pos = (base + j).clamp(0, self.max_seq_len - 1)
            active = (j <= windows) & live
            page_idx = page_table.gather(
                1, (pos // self.page_size)[:, None])[:, 0].long()
            page_idx = torch.where(active, page_idx,
                                   torch.zeros_like(page_idx))
            att_len = torch.where(active, pos + 1,
                                  torch.zeros_like(pos)).to(torch.int32)
            h = self._decode_blocks("draft", tok, pos, page_idx, page_table,
                                    att_len)
            if j < self.spec_k:
                tok = torch.argmax(self.draft_family.head(h), dim=-1)
                proposed.append(tok)
        return torch.stack(proposed, dim=1)

    def _to_device(self, arr):
        return torch.from_numpy(arr).to(self.device)

    # ------------------------------------------------------------------
    # the serving loop
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens, eos_token_id=None,
               request_id=None, priority=None, deadline_ms=None,
               ttft_slo_ms=None):
        """Enqueue one request; returns its id.

        ``priority`` is a class name (``interactive``/``batch``: eviction
        takes ``batch`` first); ``deadline_ms`` bounds the request's
        total wall clock (expired requests end with status
        ``deadline_exceeded``); ``ttft_slo_ms`` is its time-to-first-token
        objective. Under overload the admission controller raises a typed
        `RequestRejected` (terminal status ``shed``) with a retry-after
        hint, and the request never enters the queue."""
        priority = self.default_priority if priority is None else priority
        validate_priority(priority)
        for name, value in (("deadline_ms", deadline_ms),
                            ("ttft_slo_ms", ttft_slo_ms)):
            if value is not None and (
                    not isinstance(value, (int, float)) or
                    isinstance(value, bool) or value <= 0):
                raise ValueError(
                    f"{name} must be a number > 0 (milliseconds), got "
                    f"{value!r}")
        req = Request(prompt=[int(t) for t in prompt],
                      max_new_tokens=int(max_new_tokens),
                      eos_token_id=eos_token_id, request_id=request_id,
                      priority=priority,
                      deadline_ms=(None if deadline_ms is None
                                   else float(deadline_ms)),
                      ttft_slo_ms=(None if ttft_slo_ms is None
                                   else float(ttft_slo_ms)))
        if self.admission is not None:
            usable = max(self.cache.num_pages - 1, 1)
            try:
                self.admission.admit(
                    req, queue_depth=len(self.scheduler.waiting) +
                    len(self.scheduler.quarantined),
                    page_pool_util=1.0 - self.cache.num_free / usable)
            except Exception:
                self.stats["requests_shed"] += 1
                raise
        return self.scheduler.add_request(req, now=time.perf_counter())

    def step(self):
        """One scheduler step: admit + prefill new requests, decode one
        token for every in-flight sequence (with speculation: one
        speculative window each). Returns a summary dict.

        A prefill or decode exception QUARANTINES the implicated batch
        (`_quarantine_batch`) instead of killing the server: `step()`
        raises only on a scheduler invariant. The hang watchdog is armed
        around the dispatch once the step's programs are warm and fed on
        exit, also when the step dies rather than hangs."""
        self._plan_step_faults()
        self._apply_page_pressure()
        try:
            return self._step_inner()
        finally:
            if self.watchdog is not None:
                self.watchdog.feed()
            self._release_page_pressure()

    def _step_inner(self):
        now = time.perf_counter()
        finished_before = len(self.scheduler.finished)
        with self.telemetry.span("schedule"):
            plan = self.scheduler.schedule(now=now)
        self.stats["schedule_s"] += time.perf_counter() - now
        self.stats["evictions"] += len(plan.evicted)
        if plan.empty and self.scheduler.quarantined:
            # nothing dispatchable until a backoff window closes: sleep
            # toward the earliest retry_at (capped, so run() / drain()
            # stay responsive) instead of spinning step() and burning
            # scripted fault serials on idle steps
            wake = min((r.retry_at for r in self.scheduler.quarantined
                        if r.retry_at is not None), default=now)
            time.sleep(min(max(wake - time.perf_counter(), 0.0), 0.05))
        for req in plan.prefills:
            if req.admitted_at is not None and req.enqueued_at is not None:
                wait = req.admitted_at - req.enqueued_at
                self.stats["admission_wait_s"] += wait
                self.request_metrics.observe_admission_wait(wait)
        usable = max(self.cache.num_pages - 1, 1)
        self.stats["queue_depth"] = float(len(self.scheduler.waiting))
        self.stats["page_pool_util"] = 1.0 - self.cache.num_free / usable

        if self.watchdog is not None and self._programs_warm(plan):
            self.watchdog.arm()

        if plan.prefills:
            t0 = time.perf_counter()
            ok = True
            with self.telemetry.span("prefill"):
                try:
                    if self._fault_fired("prefill_error") is not None:
                        raise InjectedServingFault(
                            "injected prefill_error fault")
                    self._run_prefill(plan)
                except Exception as e:  # noqa: BLE001 - quarantine
                    ok = False
                    self._quarantine_batch(plan.prefills, e, "prefill")
            self.stats["prefill_s"] += time.perf_counter() - t0
            if ok:
                self.stats["prefill_requests"] += len(plan.prefills)
                # r.cached is the pre-sampling context length (complete_
                # prefill pins it before appending the first token)
                self.stats["prefill_tokens"] += \
                    sum(r.cached for r in plan.prefills)

        # a prefill that lost the pools mid-execution evicted every
        # running sequence (`_recover_cache_if_lost`): the planned decode
        # batch would read zeroed pages and append garbage tokens, so it
        # is skipped and the evicted requests re-prefill on later steps
        produced = 0
        if plan.decodes and all(r.state == RUNNING for r in plan.decodes):
            stall = self._fault_fired("decode_stall")
            if stall is not None:
                time.sleep(stall["seconds"])   # drives the watchdog
            t0 = time.perf_counter()
            ok = True
            with self.telemetry.span("decode"):
                try:
                    if self._fault_fired("decode_error") is not None:
                        raise InjectedServingFault(
                            "injected decode_error fault")
                    produced = (self._run_speculative(plan) if self.spec_k
                                else self._run_decode(plan))
                except Exception as e:  # noqa: BLE001
                    ok = False
                    produced = 0
                    self._quarantine_batch(plan.decodes, e, "decode")
            self.stats["decode_s"] += time.perf_counter() - t0
            if ok:
                self.stats["decode_tokens"] += produced

        finished = len(self.scheduler.finished) - finished_before
        self.stats["finished"] += finished
        self.stats["steps"] += 1
        self._sync_status_counts()
        if self.admission is not None and finished:
            self.admission.note_finished(finished)
        self._record_request_spans(plan)
        if self.monitor is not None:
            self._record_serve_scalars()
        return {"prefilled": len(plan.prefills), "decoded": produced,
                "evicted": len(plan.evicted), "finished": finished}

    def _record_serve_scalars(self):
        """The per-step saturation series keyed by total generated
        tokens (the Serve/* convention; buffered, no per-step flush): the
        queue depth, the page-pool occupancy, the running batch, the
        per-status terminal counters, and the prefix-cache and
        speculative figures where those are on. Host floats only."""
        total = self.stats["prefill_tokens"] + self.stats["decode_tokens"]
        scalars = {
            "Serve/queue_depth": self.stats["queue_depth"],
            "Serve/page_pool_util": self.stats["page_pool_util"],
            "Serve/running": float(len(self.scheduler.running))}
        for status, tag in REQUEST_STATUS_FAMILIES.items():
            scalars[tag] = float(self.stats[f"requests_{status}"])
        if self.prefix_cache is not None:
            pcs = self.prefix_cache.stats
            scalars[PREFIX_HIT_RATE] = pcs["hits"] / max(pcs["lookups"], 1)
            scalars[PREFIX_PAGES_SHARED] = float(pcs["pages_shared"])
            scalars[PREFIX_SAVED_PREFILL_TOKENS] = \
                float(pcs["saved_prefill_tokens"])
        if self.spec_k:
            scalars[SPEC_ACCEPTANCE_RATE] = \
                self.stats["spec_accepted"] / \
                max(self.stats["spec_proposed"], 1)
        self.monitor.record(total, scalars)

    def _record_request_spans(self, plan):
        """Per-request lifecycle records behind the telemetry capture:
        while a capture window is open, every request that FINISHED this
        step lands in the span buffer as one event covering submit → last
        token. Zero cost outside a window."""
        tracer = getattr(self.telemetry, "tracer", None)
        if tracer is None or not tracer.capturing:
            return
        now = time.perf_counter()
        for req in plan.prefills + plan.decodes:
            if req.state == FINISHED and req.submitted_at is not None:
                tracer.record_event(
                    f"request/{req.request_id}", req.submitted_at,
                    (req.last_token_at or now) - req.submitted_at)

    def _sync_status_counts(self):
        """Mirror the scheduler's terminal-status tallies into the stats
        (``shed`` is the engine's own: shed requests never enter the
        scheduler)."""
        sc = self.scheduler.status_counts
        self.stats["requests_ok"] = sc["ok"]
        self.stats["requests_deadline_exceeded"] = sc["deadline_exceeded"]
        self.stats["requests_failed"] = sc["failed"]

    # ------------------------------------------------------------------
    # step-failure quarantine + serving fault injection
    # ------------------------------------------------------------------

    def _plan_step_faults(self):
        """One injector turn a serving step: keep the serving-kind host
        faults fired for this step (training kinds in a shared
        DS_FAULT_INJECT plan are ignored here)."""
        self._step_faults = []
        if self.fault_injector is None:
            return
        self.fault_injector.plan_next_step()
        self._step_faults = [
            f for f in self.fault_injector.take_host_faults()
            if f["kind"] in SERVING_FAULT_KINDS]

    def _fault_fired(self, kind):
        return next((f for f in self._step_faults if f["kind"] == kind),
                    None)

    def _apply_page_pressure(self):
        """``page_pool_pressure`` fault: seize a fraction of the FREE
        pool for this step, so scheduling runs under memory pressure
        (eviction, admission shedding); released at step end."""
        fault = self._fault_fired("page_pool_pressure")
        if fault is None:
            return
        n = int(self.cache.num_free * fault["factor"])
        got = self.cache.allocate(n)
        if got:
            self._pressure_pages.extend(got)
            logger.warning(
                f"fault injection: page_pool_pressure seized {len(got)} "
                f"free page(s) for this step")

    def _release_page_pressure(self):
        if self._pressure_pages:
            self.cache.free(self._pressure_pages)
            self._pressure_pages = []

    def _quarantine_batch(self, requests, exc, phase):
        """A prefill or decode step failed: quarantine every implicated
        request. Attribution is batch-granular (the failing request
        cannot be told apart inside one batched call); an innocent
        co-batched request resets its failure run at its next completed
        step. A transient failure gets a capped, jittered retry; a
        request failing ``retry.max_attempts`` consecutive steps is
        poisoned with a typed `RequestFailed`.

        A quarantined request frees its pages and re-prefills from its
        full context, so K/V that a call wrote past the request's
        committed length before it raised (torch writes the pools in
        place, layer by layer) is never read. A sticky CUDA error (an
        illegal address) cannot be recovered in-process: every later
        call fails too, until the requests are poisoned."""
        now = time.perf_counter()
        self._recover_cache_if_lost(now)
        # the exception rides on poisoned requests (RequestFailed.
        # last_error) that live until the caller pops them: drop its
        # traceback now, or its frames pin this step's tensors (and the
        # engine) for that whole lifetime
        exc.__traceback__ = None
        rp = self.retry_params
        poisoned = 0
        for req in requests:
            if req.state == FINISHED:
                continue       # cache-loss recovery may have failed it
            req.failures += 1
            if req.failures >= rp["max_attempts"]:
                poisoned += 1
                self.scheduler.finish_failed(req, RequestFailed(
                    f"request {req.request_id} failed {req.failures} "
                    f"consecutive {phase} steps — poisoned "
                    f"({type(exc).__name__}: {exc})",
                    last_error=exc, attempts=req.failures))
            else:
                delay_ms = backoff_delay(
                    req.failures, rp["backoff_base_ms"],
                    rp["backoff_cap_ms"], rp["jitter"], self._retry_rng)
                self.scheduler.quarantine_request(
                    req, retry_at=now + delay_ms / 1e3, now=now)
                self.stats["retries"] += 1
        self.stats["quarantines"] += 1
        logger.warning(
            f"serving {phase} step failed ({type(exc).__name__}: {exc}) "
            f"— quarantined {len(requests)} request(s) "
            f"({poisoned} poisoned); the server stays up")

    def _recover_cache_if_lost(self, now):
        """A step that lost the K/V pools mid-execution (their storage
        released: `PagedKVCache.pools_lost`, the port's counterpart of a
        consumed donated buffer) leaves every cached context gone:
        rebuild the pools zeroed (the draft's too), drop the prefix
        registry and evict every running sequence, which re-prefills
        from its full token history on readmission. Errors that leave
        the pools allocated (the common case, injected faults included)
        skip this."""
        lost = self.cache.pools_lost() or (
            self.draft_cache is not None and self.draft_cache.pools_lost())
        if not lost:
            return
        logger.error(
            "serving step lost the KV pools mid-execution — rebuilding "
            "zeroed pools and re-prefilling every running sequence")
        self.cache.reset_pools()
        if self.draft_cache is not None:
            self.draft_cache.reset_pools()
        if self.prefix_cache is not None:
            # registered prefix K/V died with the pools: drop every chain
            # and detach waiting attachments, or new requests would share
            # zeroed pages
            self.prefix_cache.clear()
            self.scheduler.detach_waiting_prefixes()
        while self.scheduler.running:
            self.scheduler._evict_victim(now)

    def _programs_warm(self, plan):
        """True when every bucket program this plan dispatches has run
        at least once in this engine (its count in `program_calls`, which
        `_program` bumps before the call): a first call builds the kernel
        library with nvcc and sets up cuBLAS handles and workspaces, and
        the watchdog must not count that as a hang."""
        def warm(key):
            return self.program_calls.get(key, 0) >= 1
        if plan.empty:
            return False
        if plan.prefills:
            B, S = plan.prefill_batch, plan.prefill_len
            pkey = (("chunk", "target", "sample", B, S)
                    if plan.prefill_kind == "chunk"
                    else ("prefill", B, S))
            if not warm(pkey):
                return False
            if self.spec_k and not warm(("chunk", "draft", "write", B, S)):
                return False
        if plan.decodes:
            B = plan.decode_batch
            if self.spec_k:
                if not warm(("spec_propose", B)) or not warm(
                        ("chunk", "target", "verify", B, self.spec_k + 1)):
                    return False
            elif not warm(("decode", B)):
                return False
        return True

    def _on_serving_hang(self):
        """Watchdog expiry (on the watchdog thread): the step blew its
        wall-clock deadline. Dump every thread's stack and request a
        drain: `run()` stops admissions and performs the drain with its
        typed in-flight failures if and when the stuck step returns."""
        from ..runtime.sentinel import dump_all_stacks
        self.watchdog_fires += 1
        self.last_stack_dump = dump_all_stacks()
        logger.error(
            f"serving hang watchdog: step exceeded "
            f"{self.watchdog.timeout_s:.1f}s — requesting an emergency "
            f"drain; all-thread stacks:\n{self.last_stack_dump}")
        self._drain_requested = True
        try:
            if self.monitor is not None:
                self.monitor.flush()
        except Exception:  # noqa: BLE001 - best-effort from the thread
            pass

    def _complete_prefills(self, reqs, nxt):
        now = time.perf_counter()
        for i, req in enumerate(reqs):
            self.scheduler.complete_prefill(req, int(nxt[i]))
            # TTFT: once per request, from the ORIGINAL submit — an
            # evicted request's re-prefill must not re-count
            if req.first_token_at is None and req.submitted_at is not None:
                req.first_token_at = now
                ttft_s = now - req.submitted_at
                self.request_metrics.observe_ttft(ttft_s)
                if self.admission is not None:
                    # the shedding signal: the measured TTFT EMA
                    self.admission.observe_ttft(ttft_s * 1e3)
            req.last_token_at = now

    def _check_private(self, pages, start, n):
        """A window writes slots ``start .. start + n - 1``: each page it
        reaches must be held by this request alone (refcount 1). A
        shared prefix page or a registered one is never written. A debug
        check: the windows call it on the CPU only (the tests' engines),
        so the served path on the card pays no host work for it."""
        ps = self.page_size
        for page in pages[start // ps:(start + n - 1) // ps + 1]:
            if self.cache.refcount(page) != 1:
                raise RuntimeError(
                    f"a window write reaches page {page}, held "
                    f"{self.cache.refcount(page)} times: shared pages "
                    f"are read-only")

    def _chunk_arrays(self, reqs, B, S):
        """Window inputs of the chunk program: each request's suffix
        (everything past its shared prefix pages: the whole context when
        nothing is shared) at its absolute positions, and the full-width
        page table (shared pages included: the window attends over the
        prefix K/V it did not write)."""
        tokens = np.zeros((B, S), np.int64)
        start = np.zeros((B,), np.int32)
        n_new = np.zeros((B,), np.int32)
        page_table = np.zeros((B, self.n_pages_max), np.int32)
        for i, req in enumerate(reqs):
            shared = req.n_shared * self.page_size
            suffix = req.context[shared:]
            tokens[i, :len(suffix)] = suffix
            start[i] = shared
            n_new[i] = len(suffix)
            page_table[i, :len(req.pages)] = req.pages
            if self.device.type == "cpu":
                self._check_private(req.pages, shared, len(suffix))
        return [self._to_device(a) for a in (tokens, start, n_new,
                                             page_table)]

    def _run_prefill(self, plan):
        B, S = plan.prefill_batch, plan.prefill_len
        chunk = (self._chunk_arrays(plan.prefills, B, S)
                 if plan.prefill_kind == "chunk" or self.spec_k else None)
        if plan.prefill_kind == "chunk":
            # prefix-hit batch: the suffix-only window through the chunk
            # program (the full-prefill scatter would overwrite the
            # shared pages other requests read)
            self._program("chunk", "target", "sample", B, S)
            nxt = self._chunk("target", "sample", *chunk)
        else:
            n_pages_row = S // self.page_size
            tokens = np.zeros((B, S), np.int64)
            lengths = np.zeros((B,), np.int32)
            page_table = np.zeros((B, n_pages_row), np.int32)
            for i, req in enumerate(plan.prefills):
                ctx = req.context
                tokens[i, :len(ctx)] = ctx
                lengths[i] = len(ctx)
                page_table[i, :len(req.pages)] = req.pages
            self._program("prefill", B, S)
            nxt = self._prefill(self._to_device(tokens),
                                self._to_device(lengths),
                                self._to_device(page_table))
        if self.spec_k:
            # the draft's twin of every prefill: its K/V for each newly
            # written position lands at the same page ids (shared prefix
            # pages already hold the registrant's draft K/V)
            self._program("chunk", "draft", "write", B, S)
            self._chunk("draft", "write", *chunk)
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
        self._program("decode", B)
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

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------

    @staticmethod
    def _accept_greedy(tgt, proposed, w):
        """Greedy acceptance: `tgt[j]` (the verify's argmax at window
        index j) IS the token sequential greedy decode would produce
        there; proposals only decide how many of them land in one step.
        Accept while the draft agrees; the first disagreement appends
        the target's correction and stops; full agreement earns the
        bonus token `tgt[w]`. Token-identical to plain greedy decode."""
        out = []
        for j in range(w):
            out.append(int(tgt[j]))
            if int(proposed[j]) != int(tgt[j]):
                return out
        out.append(int(tgt[w]))
        return out

    def _accept_sampled(self, probs, proposed, w):
        """Rejection-sampling acceptance against the target's
        temperature-scaled distributions (`probs` [S, V] fp32). The
        draft proposes greedily (a delta distribution at x), so the
        accept test ``u < p(x)/q(x)`` reduces to ``u < p(x)`` and the
        residual (p - q)⁺ to p with x zeroed: each emitted token is
        distributed as sequential sampling from p."""
        out = []
        for j in range(w):
            p = np.asarray(probs[j], np.float64)
            x = int(proposed[j])
            if self._spec_rng.random() < p[x]:
                out.append(x)
                continue
            p[x] = 0.0
            total = p.sum()
            if total <= 0.0:
                out.append(x)     # p WAS the delta at x: accept it
            else:
                out.append(int(self._spec_rng.choice(len(p),
                                                     p=p / total)))
            return out
        p = np.asarray(probs[w], np.float64)
        out.append(int(self._spec_rng.choice(len(p), p=p / p.sum())))
        return out

    def _run_speculative(self, plan):
        """One speculative decode step: the draft proposes up to k tokens
        a row, the target verifies the whole window in ONE chunk call,
        and acceptance appends 1..k+1 tokens a row. Pages grown for
        tokens the shrinking window will never reach roll back through
        the allocator (`scheduler._rollback_spec_pages`). Returns the
        tokens appended across the batch."""
        B = plan.decode_batch
        reqs = plan.decodes
        tokens = np.zeros((B,), np.int64)
        lengths = np.zeros((B,), np.int32)
        windows = np.full((B,), -1, np.int32)
        page_table = np.zeros((B, self.n_pages_max), np.int32)
        for i, req in enumerate(reqs):
            tokens[i] = req.generated[-1]
            lengths[i] = req.cached + 1
            windows[i] = self.scheduler._spec_window(req)
            page_table[i, :len(req.pages)] = req.pages
            if self.device.type == "cpu":
                self._check_private(req.pages, req.cached, windows[i] + 1)
        pt = self._to_device(page_table)
        self._program("spec_propose", B)
        proposed = self._propose(self._to_device(tokens),
                                 self._to_device(lengths),
                                 self._to_device(windows), pt).cpu().numpy()

        # the verify window a row: [pending token, proposals[:w]] at
        # positions cached..cached+w; the pending token's K/V enters the
        # target cache here, as in a plain decode step
        S = self.spec_k + 1
        wtokens = np.zeros((B, S), np.int64)
        n_new = np.zeros((B,), np.int32)
        for i in range(len(reqs)):
            w = int(windows[i])
            wtokens[i, 0] = tokens[i]
            wtokens[i, 1:1 + w] = proposed[i, :w]
            n_new[i] = w + 1
        start = np.maximum(lengths - 1, 0).astype(np.int32)
        self._program("chunk", "target", "verify", B, S)
        out = self._chunk("target", "verify", self._to_device(wtokens),
                          self._to_device(start), self._to_device(n_new),
                          pt).cpu().numpy()

        now = time.perf_counter()
        produced = 0
        for i, req in enumerate(reqs):
            w = int(windows[i])
            if self.temperature <= 0.0:
                accepted = self._accept_greedy(out[i], proposed[i], w)
            else:
                accepted = self._accept_sampled(out[i], proposed[i], w)
            self.stats["spec_proposed"] += w
            self.stats["spec_accepted"] += len(accepted) - 1
            appended = self.scheduler.complete_speculative(req, accepted)
            produced += appended
            if req.last_token_at is not None and appended:
                # the user-visible cadence: one step emitted `appended`
                # tokens, so each token's inter-token gap is dt/appended
                per_token = (now - req.last_token_at) / appended
                for _ in range(appended):
                    self.request_metrics.observe_inter_token(per_token)
            req.last_token_at = now
        self.stats["spec_steps"] += 1
        return produced

    # ------------------------------------------------------------------
    # graceful drain (SIGTERM from the pod scheduler)
    # ------------------------------------------------------------------
    #
    # Serving takes no emergency checkpoint: the right shutdown is to
    # stop admitting, finish what is running (bounded by
    # `inference.drain_deadline_s`), fail the rest with a typed status
    # and exit 0 so the orchestrator sees a clean termination.

    def install_drain_handler(self):
        """Register SIGTERM / SIGINT to REQUEST a drain (a flag only);
        `run()` performs the drain at its next loop iteration. Weakly
        bound: the signal registry must not pin the engine (and its page
        pools) for the life of the process. A no-op off the main
        thread."""
        import signal as _signal
        import threading
        import weakref
        if threading.current_thread() is not threading.main_thread():
            return self
        engine_ref = weakref.ref(self)

        def handler(signum, frame):  # noqa: ARG001
            engine = engine_ref()
            if engine is not None:
                engine._drain_requested = True

        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                self._prev_handlers[sig] = _signal.signal(sig, handler)
            except (ValueError, OSError):  # pragma: no cover
                pass
        return self

    def restore_signal_handlers(self):
        import signal as _signal
        for sig, handler in self._prev_handlers.items():
            try:
                _signal.signal(sig, handler)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev_handlers = {}

    def request_drain(self):
        """The programmatic equivalent of the SIGTERM handler."""
        self._drain_requested = True

    def drain(self, deadline_s=None):
        """Stop admissions, finish in-flight sequences for at most
        ``deadline_s`` (``inference.drain_deadline_s`` by default), then
        fail whatever is still in flight or quarantined with a typed
        `DrainAborted`. Returns a summary dict; fresh queued requests are
        left unserved (``unserved`` counts them) for the replacement
        instance."""
        deadline_s = (self.drain_deadline_s if deadline_s is None
                      else float(deadline_s))
        self.scheduler.stop_admissions()
        t0 = time.perf_counter()
        deadline_hit = False
        while self.scheduler.has_inflight_work:
            if time.perf_counter() - t0 > deadline_s:
                deadline_hit = True
                break
            self.step()
        abandoned = 0
        for req in self.scheduler.inflight_requests():
            self.scheduler.finish_failed(req, DrainAborted(
                f"graceful-drain deadline ({deadline_s:.1f}s) elapsed "
                f"with request {req.request_id} still in flight "
                f"({len(req.generated)}/{req.max_new_tokens} tokens "
                f"generated)", attempts=req.failures))
            abandoned += 1
        self._sync_status_counts()
        summary = {
            "drained_s": time.perf_counter() - t0,
            "deadline_hit": deadline_hit,
            "inflight_abandoned": abandoned,
            "unserved": sum(1 for r in self.scheduler.waiting
                            if not r.evictions),
        }
        # pushes the Serve/* counters (the DrainAborted failures land in
        # Serve/requests_failed BEFORE the monitor closes)
        self.serve_stats()
        if self.monitor is not None:
            if self._owns_monitor:
                self.monitor.close()  # drains the buffered scalar queue
            else:
                # borrowed: flush the Serve/* scalars, leave it open
                flush = getattr(self.monitor, "flush", None)
                if flush is not None:
                    flush()
        self.telemetry.close()
        self.restore_signal_handlers()
        logger.info(f"inference drain complete: {summary}")
        return summary

    def run(self, max_steps=None):
        """Drive steps until the queue drains (or `max_steps`). A pending
        drain request (SIGTERM through `install_drain_handler`,
        `request_drain()` or the hang watchdog) switches to `drain` and
        exits the process with code 0 once in-flight work is done, also
        on an idle server."""
        steps = 0
        while True:
            if self._drain_requested:
                self.drain()
                raise SystemExit(0)
            if not self.scheduler.has_work:
                break
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

    def generate_rollouts(self, prompts, max_new_tokens, eos_token_id=None):
        """`generate` plus the accounting of this call only: ``(outputs,
        stats)`` with the rollout wall seconds, the generated tokens, their
        rate, the new bucket programs (``compile_delta``) and, with
        speculation, the acceptance rate."""
        before = {"compile": self.compile_count(),
                  "spec_proposed": self.stats["spec_proposed"],
                  "spec_accepted": self.stats["spec_accepted"]}
        t0 = time.perf_counter()
        outputs = self.generate(prompts, max_new_tokens,
                                eos_token_id=eos_token_id)
        rollout_s = time.perf_counter() - t0
        tokens = sum(len(o) for o in outputs)
        stats = {
            "rollout_s": rollout_s,
            "rollout_tokens": tokens,
            "tokens_per_s": tokens / max(rollout_s, 1e-9),
            "compile_delta": self.compile_count() - before["compile"],
        }
        if self.spec_k:
            proposed = self.stats["spec_proposed"] - before["spec_proposed"]
            accepted = self.stats["spec_accepted"] - before["spec_accepted"]
            stats["spec_acceptance_rate"] = accepted / max(proposed, 1)
        return outputs, stats

    def serve_stats(self):
        """Counters + phase seconds + request-latency percentiles (p50/p99
        of admission wait / TTFT / inter-token, from the fixed-bucket
        histograms), with the prefix registry's and the speculative
        acceptance's figures when those are on; also pushed to the
        monitor (as ``Serve/*`` scalars keyed by total generated tokens)
        when one is attached."""
        out = dict(self.stats)
        out.update(self.request_metrics.summary())
        if self.prefix_cache is not None:
            pcs = self.prefix_cache.stats
            out["prefix_lookups"] = pcs["lookups"]
            out["prefix_hits"] = pcs["hits"]
            out["prefix_hit_rate"] = pcs["hits"] / max(pcs["lookups"], 1)
            out["prefix_pages_shared"] = pcs["pages_shared"]
            out["prefix_saved_prefill_tokens"] = \
                pcs["saved_prefill_tokens"]
        if self.spec_k:
            out["spec_acceptance_rate"] = self.stats["spec_accepted"] / \
                max(self.stats["spec_proposed"], 1)
        if self.monitor is not None:
            total = out["prefill_tokens"] + out["decode_tokens"]
            self.monitor.record(
                total, {f"Serve/{k}": float(v) for k, v in out.items()})
        return out
