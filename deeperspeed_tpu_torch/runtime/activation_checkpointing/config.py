"""The "activation_checkpointing" config block: the port of
`deeperspeed_tpu/runtime/activation_checkpointing/config.py` (reference:
`deepspeed/runtime/activation_checkpointing/config.py`), with the same
keys, defaults and errors.

In the port these knobs steer `torch.utils.checkpoint` spans
(`checkpointing.make_remat_policy`): `policy` names what a span keeps
for the backward, `number_checkpoints` groups the layer stack into
spans, `cpu_checkpointing` selects the host-offload policy, and
`partition_activations` (a no-op on one rank: there is no model axis to
shard over), `contiguous_memory_optimization`,
`synchronize_checkpoint_boundary` and `profile` are accepted no-ops, as
in the JAX package.
"""

from dataclasses import dataclass

from ..config_utils import DeepSpeedConfigError, get_scalar_param

ACT_CHKPT = "activation_checkpointing"
ACT_CHKPT_PARTITION_ACTIVATIONS = "partition_activations"
ACT_CHKPT_NUMBER_CHECKPOINTS = "number_checkpoints"
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION = "contiguous_memory_optimization"
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY = "synchronize_checkpoint_boundary"
ACT_CHKPT_PROFILE = "profile"
ACT_CHKPT_CPU_CHECKPOINTING = "cpu_checkpointing"
# Fork key: the named rematerialization policy (see
# checkpointing.make_remat_policy for semantics).
ACT_CHKPT_POLICY = "policy"

ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT = False
ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT = None
ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT = False
ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT = False
ACT_CHKPT_PROFILE_DEFAULT = False
ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT = False
ACT_CHKPT_POLICY_DEFAULT = None

REMAT_POLICY_CHOICES = ("none", "full", "dots", "attn_residuals",
                        "offload_dots")


def _validate_number_checkpoints(value):
    """Parse-time check: a positive int or None. The model-side cap
    (<= num_layers) is enforced where the layer count is known
    (`apply_ds_config`)."""
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, int):
        raise DeepSpeedConfigError(
            f"{ACT_CHKPT}.{ACT_CHKPT_NUMBER_CHECKPOINTS} must be a "
            f"positive int or null, got {value!r}")
    if value <= 0:
        raise DeepSpeedConfigError(
            f"{ACT_CHKPT}.{ACT_CHKPT_NUMBER_CHECKPOINTS} must be > 0, "
            f"got {value}")
    return value


def _validate_policy(value):
    if value is None:
        return None
    if value not in REMAT_POLICY_CHOICES:
        raise DeepSpeedConfigError(
            f"{ACT_CHKPT}.{ACT_CHKPT_POLICY}: unknown remat policy "
            f"{value!r}; valid choices: {', '.join(REMAT_POLICY_CHOICES)}")
    return value


@dataclass(frozen=True)
class DeepSpeedActivationCheckpointingConfig:
    partition_activations: bool = ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT
    number_checkpoints: object = ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT
    contiguous_memory_optimization: bool = (
        ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT)
    synchronize_checkpoint_boundary: bool = (
        ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT)
    profile: bool = ACT_CHKPT_PROFILE_DEFAULT
    cpu_checkpointing: bool = ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT
    policy: object = ACT_CHKPT_POLICY_DEFAULT

    @property
    def active(self):
        """True when the block asks for anything beyond the defaults that
        the engine must thread into the model forward."""
        return (self.policy is not None
                or self.number_checkpoints is not None
                or self.partition_activations
                or self.cpu_checkpointing)

    @classmethod
    def from_dict(cls, param_dict):
        d = param_dict.get(ACT_CHKPT) or {}
        policy = _validate_policy(get_scalar_param(
            d, ACT_CHKPT_POLICY, ACT_CHKPT_POLICY_DEFAULT))
        cpu = bool(get_scalar_param(d, ACT_CHKPT_CPU_CHECKPOINTING,
                                    ACT_CHKPT_CPU_CHECKPOINTING_DEFAULT))
        if cpu and policy in ("none", "full", "attn_residuals"):
            # cpu_checkpointing promotes the (default/'dots') policy to
            # its host-offload form; with these policies there is no
            # offloadable save set — silently ignoring either knob would
            # hide a misconfiguration
            raise DeepSpeedConfigError(
                f"{ACT_CHKPT}: cpu_checkpointing=true conflicts with "
                f"policy={policy!r} (nothing it saves can offload); use "
                "policy 'dots'/'offload_dots' or drop cpu_checkpointing")
        return cls(
            partition_activations=bool(get_scalar_param(
                d, ACT_CHKPT_PARTITION_ACTIVATIONS,
                ACT_CHKPT_PARTITION_ACTIVATIONS_DEFAULT)),
            number_checkpoints=_validate_number_checkpoints(
                get_scalar_param(d, ACT_CHKPT_NUMBER_CHECKPOINTS,
                                 ACT_CHKPT_NUMBER_CHECKPOINTS_DEFAULT)),
            contiguous_memory_optimization=bool(get_scalar_param(
                d, ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION,
                ACT_CHKPT_CONTIGUOUS_MEMORY_OPTIMIZATION_DEFAULT)),
            synchronize_checkpoint_boundary=bool(get_scalar_param(
                d, ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY,
                ACT_CHKPT_SYNCHRONIZE_CHECKPOINT_BOUNDARY_DEFAULT)),
            profile=bool(get_scalar_param(
                d, ACT_CHKPT_PROFILE, ACT_CHKPT_PROFILE_DEFAULT)),
            cpu_checkpointing=cpu,
            policy=policy,
        )
