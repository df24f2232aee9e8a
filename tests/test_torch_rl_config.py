"""The port's "rl" config block against the JAX package's, on the CPU:
`parse_rl_block`'s defaults and parsed values, every rejection of
`tests/test_rl.py`'s `TestRLConfig.test_rejects` (read from its
parametrize mark) and more, each with the JAX package's message word
for word, and `DeepSpeedConfig.rl_params` / ``rl_enabled``."""

import pytest
import torch

from deeperspeed_tpu.runtime import constants as jc
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config import parse_rl_block as jax_parse
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError

from deeperspeed_tpu_torch.runtime import constants as c
from deeperspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                  parse_rl_block)
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

from tests import test_rl as jax_rl_tests

torch.set_num_threads(2)


def _jax_reject_cases():
    """`TestRLConfig.test_rejects`'s parametrize list: (block, match)."""
    mark = next(m for m in jax_rl_tests.TestRLConfig.test_rejects.pytestmark
                if m.name == "parametrize")
    return [tuple(case) for case in mark.args[1]]


def _same_outcome(d):
    """Both parses of ``d``: the same params, or the same error."""
    try:
        want = jax_parse(d)
    except JaxConfigError as e:
        with pytest.raises(DeepSpeedConfigError) as err:
            parse_rl_block(d)
        assert str(err.value) == str(e)
        return None
    got = parse_rl_block(d)
    assert got == want
    return got


def test_constants_match_jax():
    names = [n for n in dir(jc) if n.startswith("RL")]
    assert names
    for name in names:
        assert getattr(c, name) == getattr(jc, name), name
    assert "rl" not in c.NOT_PORTED_BLOCKS


@pytest.mark.parametrize("d", [{}, {"rl": None}, {"rl": {}},
                               {"rl": {"enabled": False}},
                               {"rl": {"enabled": False, "loss": "dpo"}}])
def test_absent_and_disabled_are_false(d):
    assert parse_rl_block(d) is False
    assert _same_outcome(d) is False


def test_defaults_match_jax():
    got = _same_outcome({"rl": {"enabled": True}})
    assert got[c.RL_LOSS] == "ppo_clip"
    assert got[c.RL_ROLLOUTS_PER_ITERATION] == 8
    assert got[c.RL_GROUP_SIZE] == 1
    assert got[c.RL_MAX_NEW_TOKENS] == 16
    assert got[c.RL_SEQUENCE_LENGTH] is None
    assert (got[c.RL_CLIP_RATIO], got[c.RL_KL_COEF], got[c.RL_BETA]) == \
        (0.2, 0.05, 0.1)
    assert got[c.RL_CHECKPOINT_INTERVAL] == 1


@pytest.mark.parametrize("block", [
    {"enabled": True, "loss": "dpo", "group_size": 4,
     "rollouts_per_iteration": 16, "sequence_length": 96, "beta": 0.5},
    {"enabled": True, "rollouts_per_iteration": 16, "group_size": 4,
     "max_new_tokens": 64, "sequence_length": 128, "clip_ratio": 0.1,
     "kl_coef": 0, "checkpoint_interval": 3},
    {"enabled": True, "rollouts_per_iteration": 1e1, "group_size": 5.0,
     "kl_coef": 1},
])
def test_values_match_jax(block):
    got = _same_outcome({"rl": block})
    assert got[c.RL_ENABLED] is True


@pytest.mark.parametrize("block,match", _jax_reject_cases(),
                         ids=lambda v: str(v) if isinstance(v, str) else None)
def test_rejects_like_jax(block, match):
    """`tests/test_rl.py`'s rejections: the same message."""
    with pytest.raises(DeepSpeedConfigError, match=match):
        parse_rl_block({"rl": block})
    _same_outcome({"rl": block})


@pytest.mark.parametrize("rl", [
    [1, 2], "ppo", 3,
    {"enabled": True, "loss": None},
    {"enabled": True, "group_size": 0},
    {"enabled": True, "max_new_tokens": 2.5},
    {"enabled": True, "rollouts_per_iteration": "eight"},
    {"enabled": True, "sequence_length": 64.5},
    {"enabled": True, "clip_ratio": "0.2"},
    {"enabled": True, "beta": 0},
    {"enabled": True, "loss": "dpo", "group_size": 3,
     "rollouts_per_iteration": 8},
    {"enabled": "yes"},
    {"enable": True},
])
def test_more_rejections_like_jax(rl):
    with pytest.raises(DeepSpeedConfigError):
        parse_rl_block({"rl": rl})
    _same_outcome({"rl": rl})


@pytest.mark.parametrize("conf", [
    {"train_batch_size": 8,
     "rl": {"enabled": True, "loss": "dpo", "group_size": 4,
            "rollouts_per_iteration": 8}},
    {"train_batch_size": 8, "rl": {"enabled": True}},
    {"train_batch_size": 8, "rl": {"enabled": False}},
    {"train_batch_size": 8},
])
def test_rides_deepspeed_config(conf):
    ours, ref = DeepSpeedConfig(conf), JaxConfig(conf, world_size=1)
    assert ours.rl_params == ref.rl_params
    assert ours.rl_enabled is ref.rl_enabled


def test_bad_block_raises_through_deepspeed_config():
    conf = {"train_batch_size": 8, "rl": {"enabled": True, "loss": "a2c"}}
    with pytest.raises(JaxConfigError) as want:
        JaxConfig(conf, world_size=1)
    with pytest.raises(DeepSpeedConfigError) as got:
        DeepSpeedConfig(conf)
    assert str(got.value) == str(want.value)
