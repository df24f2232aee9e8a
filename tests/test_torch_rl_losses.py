"""The port's RL losses and `RolloutBuffer` against the JAX package's, on
the CPU, on the same numpy inputs and the same JAX-made weights of the
tiny GPT-NeoX (fp32; the JAX model on its plain XLA path, the port's
wrappers on their plain versions):

- `token_logprobs` (atol 1e-6);
- PPO-clip and DPO values (rtol 1e-5) and gradients against `jax.grad`
  (each leaf within 2e-5 of its largest gradient), with ratios inside
  and outside the clip;
- the on-policy identities (PPO-clip = -masked-mean advantage, DPO =
  ln 2) and the registry's unknown-name error (the same message);
- every `RolloutBuffer` method: pad and mask (exact), the overflow and
  empty-response errors (the same messages), `ref_logprobs` (atol 1e-5),
  the group-normalized advantages (exact), DPO pairs (exact, first index
  on ties) and `state_dict`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeperspeed_tpu.rl import RolloutBuffer as JaxBuffer
from deeperspeed_tpu.rl import get_rl_loss as jax_get_rl_loss
from deeperspeed_tpu.rl import token_logprobs as jax_token_logprobs
from deeperspeed_tpu.runtime.config import parse_rl_block as jax_parse
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError

from deeperspeed_tpu_torch.models.convert import _flatten
from deeperspeed_tpu_torch.rl import (RolloutBuffer, get_rl_loss,
                                      register_rl_loss, token_logprobs)
from deeperspeed_tpu_torch.rl.buffer import PAD_ID
from deeperspeed_tpu_torch.runtime.config import parse_rl_block
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

from tests.torch_rl import SIZE, jax_model, jax_weights, port_model, rl_block

torch.set_num_threads(2)

B, S = 4, 16


@pytest.fixture(scope="module")
def weights():
    return jax_weights(0)


@pytest.fixture(scope="module")
def models(weights):
    return jax_model(), port_model(weights[1])


def _tokens(seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(
        1, SIZE["vocab_size"], size=(b, s)).astype(np.int32)


def _mask(b=B, s=S, lo=5, hi=13):
    mask = np.zeros((b, s - 1), np.float32)
    mask[:, lo:hi] = 1.0
    mask[0, hi:] = 1.0          # a longer response on one row
    return mask


def _logp_jax(jmodel, jparams, tokens):
    return np.asarray(jax_token_logprobs(jmodel.apply(jparams, tokens),
                                         tokens))


def _params_both(rl, **kw):
    block = {"rl": rl_block(**rl)}
    p = parse_rl_block(block)
    assert p == jax_parse(block)
    return p


def _port_loss_and_grads(model, loss_fn, batch):
    for prm in model.parameters():
        prm.grad = None
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    loss = loss_fn(model.params_tree(), tb)
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy().copy()
                         for n, p in model.named_parameters()}


def _jax_loss_and_grads(jmodel, jparams, loss_fn, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(lambda p: loss_fn(p, jb))(jparams)
    return float(loss), _flatten(jax.device_get(grads), "", {})


def _check_grads(got, want):
    """Each leaf within 2e-5 of its largest JAX gradient (at least 1e-6):
    fp32 sums in a different order."""
    assert set(got) == set(want)
    for name in want:
        ref = np.asarray(want[name])
        atol = 2e-5 * max(float(np.abs(ref).max()), 0.05)
        np.testing.assert_allclose(got[name], ref, atol=atol, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# token logprobs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_token_logprobs_match_jax(dtype):
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(3, 7, 11))).astype(dtype)
    tokens = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    got = token_logprobs(torch.from_numpy(logits), torch.from_numpy(tokens))
    want = np.asarray(jax_token_logprobs(jnp.asarray(logits),
                                         jnp.asarray(tokens)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_registry_unknown_name_like_jax():
    with pytest.raises(JaxConfigError) as want:
        jax_get_rl_loss("a2c")
    with pytest.raises(DeepSpeedConfigError) as got:
        get_rl_loss("a2c")
    assert str(got.value) == str(want.value)


def test_register_custom_loss():
    @register_rl_loss("_test_const")
    def build(model, rl_params):
        return lambda params, batch, rng=None: torch.zeros(())
    try:
        assert get_rl_loss("_test_const") is build
    finally:
        from deeperspeed_tpu_torch.rl import losses
        losses._RL_LOSSES.pop("_test_const")


# ---------------------------------------------------------------------------
# PPO-clip and DPO: values and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [0.0, 0.05, 0.5],
                         ids=["on_policy", "inside_clip", "clipped"])
def test_ppo_clip_value_and_grads_match_jax(weights, models, shift):
    jparams = weights[1]
    jmodel, model = models
    p = _params_both(dict(kl_coef=0.3, clip_ratio=0.2))
    tokens = _tokens()
    logp = _logp_jax(jmodel, jparams, tokens)
    rng = np.random.default_rng(2)
    behavior = (logp + shift * rng.normal(size=logp.shape)).astype(
        np.float32)
    ref = (logp + 0.1 * rng.normal(size=logp.shape)).astype(np.float32)
    batch = {"tokens": tokens, "mask": _mask(), "behavior_logp": behavior,
             "ref_logp": ref,
             "advantages": np.asarray([1.0, -1.0, 0.5, 2.0], np.float32)}
    want, jgrads = _jax_loss_and_grads(jmodel, jparams,
                                       jax_get_rl_loss("ppo_clip")(jmodel, p),
                                       batch)
    got, grads = _port_loss_and_grads(model, get_rl_loss("ppo_clip")(model, p),
                                      batch)
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)
    _check_grads(grads, jgrads)


@pytest.mark.parametrize("beta", [0.1, 0.7])
def test_dpo_value_and_grads_match_jax(weights, models, beta):
    jparams = weights[1]
    jmodel, model = models
    p = _params_both(dict(loss="dpo", beta=beta))
    tokens = _tokens(seed=3)
    logp = _logp_jax(jmodel, jparams, tokens)
    ref = (logp + 0.2 * np.random.default_rng(4).normal(
        size=logp.shape)).astype(np.float32)
    batch = {"tokens": tokens, "mask": _mask(), "ref_logp": ref}
    want, jgrads = _jax_loss_and_grads(jmodel, jparams,
                                       jax_get_rl_loss("dpo")(jmodel, p),
                                       batch)
    got, grads = _port_loss_and_grads(model, get_rl_loss("dpo")(model, p),
                                      batch)
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)
    _check_grads(grads, jgrads)


def test_ppo_clip_on_policy_is_minus_mean_advantage(models):
    _, model = models
    p = _params_both(dict(kl_coef=0.3))
    tokens = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        logp = token_logprobs(model.apply(model.params_tree(), tokens),
                              tokens)
    mask = torch.from_numpy(_mask())
    adv = torch.tensor([1.0, -1.0, 0.5, 2.0])
    batch = {"tokens": tokens, "mask": mask, "behavior_logp": logp,
             "ref_logp": logp, "advantages": adv}
    with torch.no_grad():
        got = float(get_rl_loss("ppo_clip")(model, p)(model.params_tree(),
                                                      batch))
    want = -float((adv[:, None] * mask).sum() / mask.sum())
    assert got == pytest.approx(want, abs=1e-6)


def test_dpo_zero_margin_is_ln2(models):
    _, model = models
    p = _params_both(dict(loss="dpo", beta=0.7))
    tokens = torch.from_numpy(_tokens(seed=2)).long()
    with torch.no_grad():
        logp = token_logprobs(model.apply(model.params_tree(), tokens),
                              tokens)
        batch = {"tokens": tokens, "mask": torch.ones(B, S - 1),
                 "ref_logp": logp}
        got = float(get_rl_loss("dpo")(model, p)(model.params_tree(),
                                                 batch))
    assert got == pytest.approx(float(np.log(2.0)), abs=1e-6)


def test_apply_matches_forward_and_jax(weights, models):
    jmodel, model = models
    tokens = _tokens(seed=5)
    t = torch.from_numpy(tokens).long()
    with torch.no_grad():
        got = model.apply(model.params_tree(), t)
        assert torch.equal(got, model(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.apply(weights[1], tokens)),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# RolloutBuffer
# ---------------------------------------------------------------------------

def _buffers(weights, models, group_size=2, seq_len=16, loss="ppo_clip"):
    jmodel, model = models
    p = _params_both(dict(group_size=group_size, loss=loss,
                          rollouts_per_iteration=2 * group_size))
    ref = {n: prm.detach().clone() for n, prm in model.named_parameters()}
    from deeperspeed_tpu_torch.models.gpt_neox import unflatten
    return (JaxBuffer(jmodel, weights[1], p, seq_len),
            RolloutBuffer(model, unflatten(ref), p, seq_len))


ROLLOUTS = [{"prompt": [5, 6, 7], "response": [8, 9], "reward": 0.0},
            {"prompt": [1], "response": [2, 3, 4], "reward": 0.0},
            {"prompt": list(range(10, 22)), "response": [7, 7, 7, 7],
             "reward": 1.0}]


def test_pad_and_mask_match_jax(weights, models):
    jbuf, buf = _buffers(weights, models)
    tokens, mask = buf.pad(ROLLOUTS)
    jt, jm = jbuf.pad(ROLLOUTS)
    assert PAD_ID == 0
    assert tokens.dtype == jt.dtype and mask.dtype == jm.dtype
    np.testing.assert_array_equal(tokens, jt)
    np.testing.assert_array_equal(mask, jm)
    assert mask[0].tolist() == [0, 0, 1, 1] + [0] * 11
    assert mask[2].tolist() == [0] * 11 + [1] * 4


@pytest.mark.parametrize("rollout", [
    {"prompt": [1, 2, 3], "response": [4, 5], "reward": 0.0},
    {"prompt": [1, 2], "response": [], "reward": 0.0},
], ids=["overflow", "empty_response"])
def test_pad_errors_match_jax(weights, models, rollout):
    jbuf, buf = _buffers(weights, models, seq_len=4)
    with pytest.raises(JaxConfigError) as want:
        jbuf.pad([rollout])
    with pytest.raises(DeepSpeedConfigError) as got:
        buf.pad([rollout])
    assert str(got.value) == str(want.value)


def test_short_sequence_length_like_jax(weights, models):
    jmodel, model = models
    p = _params_both({})
    with pytest.raises(JaxConfigError) as want:
        JaxBuffer(jmodel, weights[1], p, 1)
    with pytest.raises(DeepSpeedConfigError) as got:
        RolloutBuffer(model, model.params_tree(), p, 1)
    assert str(got.value) == str(want.value)


def test_ref_logprobs_match_jax(weights, models):
    jbuf, buf = _buffers(weights, models)
    tokens, _ = buf.pad(ROLLOUTS)
    got = buf.ref_logprobs(tokens)
    assert got.dtype == np.float32 and got.shape == (3, 15)
    np.testing.assert_allclose(got, jbuf.ref_logprobs(tokens), atol=1e-5,
                               rtol=0)


def test_ref_params_are_frozen_copies(weights, models):
    """The buffer scores with the tree it was given, not the model's
    live parameters."""
    _, buf = _buffers(weights, models)
    _, model = models
    tokens, _ = buf.pad(ROLLOUTS)
    before = buf.ref_logprobs(tokens)
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    try:
        with torch.no_grad():
            for prm in model.parameters():
                prm.add_(0.5)
        np.testing.assert_array_equal(buf.ref_logprobs(tokens), before)
    finally:
        with torch.no_grad():
            for n, prm in model.named_parameters():
                prm.copy_(saved[n])


@pytest.mark.parametrize("group_size,rewards", [
    (2, [1.0, 3.0, 10.0, 10.0]),
    (4, [0.5, 2.0, -1.0, 7.0, 3.0, 3.0, 3.0, 9.0]),
    (1, [1.0, 2.0, 4.0, 8.0]),
])
def test_advantages_match_jax(weights, models, group_size, rewards):
    jbuf, buf = _buffers(weights, models, group_size=group_size)
    got = buf.advantages(rewards)
    np.testing.assert_array_equal(got, jbuf.advantages(rewards))
    assert got.dtype == np.float32


def test_dpo_pairs_match_jax(weights, models):
    """Group extremes, chosen first; a tie takes the first index."""
    jbuf, buf = _buffers(weights, models, group_size=3, loss="dpo")
    rollouts = [{"prompt": [1], "response": [t], "reward": r}
                for t, r in zip(range(10, 19),
                                [0.5, 2.0, 1.0, 7.0, 3.0, 9.0,
                                 4.0, 4.0, 4.0])]
    rewards = [r["reward"] for r in rollouts]
    tokens, mask = buf.pad(rollouts)
    ref = buf.ref_logprobs(tokens)
    got = buf.build_dpo_batch(tokens, mask, ref, rewards)
    want = jbuf.build_dpo_batch(tokens, mask, ref, rewards)
    assert set(got) == set(want) == {"tokens", "mask", "ref_logp"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["tokens"][:, 1].tolist() == [11, 10, 15, 14, 16, 16]
    assert buf.consumed == jbuf.consumed == 9


def test_ppo_batch_matches_jax(weights, models):
    jbuf, buf = _buffers(weights, models)
    rollouts = ROLLOUTS + [{"prompt": [3], "response": [1], "reward": 5.0}]
    rewards = [0.0, 1.0, 2.0, 5.0]
    tokens, mask = buf.pad(rollouts)
    ref = buf.ref_logprobs(tokens)
    behavior = ref + np.float32(0.01)
    got = buf.build_ppo_batch(tokens, mask, behavior, ref, rewards)
    want = jbuf.build_ppo_batch(tokens, mask, behavior, ref, rewards)
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert buf.consumed == jbuf.consumed == 4


def test_state_dict_round_trip(weights, models):
    jbuf, buf = _buffers(weights, models)
    buf.consumed = jbuf.consumed = 12
    assert buf.state_dict() == jbuf.state_dict() == {"consumed": 12}
    _, fresh = _buffers(weights, models)
    fresh.load_state_dict(jbuf.state_dict())
    assert fresh.consumed == 12
