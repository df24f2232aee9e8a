"""`ds_report` environment report (reference: `deepspeed/env_report.py`):
the port of `deeperspeed_tpu/env_report.py`.

Reports the op availability matrix (the Python ops and every C entry
point of the hand-written kernel library, `ops/compat.py`) and the
PyTorch / CUDA environment: the torch and CUDA versions, the card and
the kernel library's build (`ops/hopper/_build.BUILD_INFO`).

    python -m deeperspeed_tpu_torch.env_report [--json]

On a host without `nvcc` or without a card every kernel reads
unavailable and the report still exits 0.
"""

GREEN = "\033[92m"
RED = "\033[91m"
YELLOW = "\033[93m"
END = "\033[0m"
SUCCESS = f"{GREEN}[YES]{END}"
WARNING = f"{YELLOW}[WARNING]{END}"
FAIL = f"{RED}[FAIL]{END}"
OKAY = f"{GREEN}[OKAY]{END}"


def _probe_ops():
    """{op name: available}; a probe that raises reads unavailable."""
    from .ops.compat import ALL_OPS
    ops = {}
    for name, check in ALL_OPS.items():
        try:
            ops[name] = bool(check())
        except Exception:  # noqa: BLE001 - probe failure = unavailable
            ops[name] = False
    return ops


def op_report():
    """Op/kernel availability matrix, printed; returns [(name, ok)]."""
    max_dots = 23
    print("-" * 64)
    print("DeeperSpeed (PyTorch/CUDA) op/kernel report")
    print("-" * 64)
    print("op name", "." * max_dots, "available")
    print("-" * 64)
    rows = []
    for name, ok in _probe_ops().items():
        status = OKAY if ok else FAIL
        print(name, "." * max(max_dots + 8 - len(name), 1), status)
        rows.append((name, ok))
    print("-" * 64)
    return rows


def env_fingerprint():
    """Machine-readable environment identity: versions, the card, its
    compute capability and name, and the kernel library's
    build (path, whether this process built it, the build seconds). What
    `--json` prints and what a trace's metadata can carry."""
    import numpy as np
    import torch

    from .ops.hopper import _build
    from .version import __version__

    info = {
        "deeperspeed_tpu_torch": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "cuda_available": torch.cuda.is_available(),
    }
    if torch.cuda.is_available():
        info.update({
            "device_count": torch.cuda.device_count(),
            "device_name": torch.cuda.get_device_name(0),
            "capability": "{}.{}".format(
                *torch.cuda.get_device_capability(0)),
        })
    else:
        info.update({"device_count": 0, "device_name": None,
                     "capability": None})
    info["build"] = {k: _build.BUILD_INFO[k] for k in
                     ("path", "built", "seconds")
                     if k in _build.BUILD_INFO} or None
    return info


def json_report():
    """The full ``--json`` payload: environment fingerprint, op/kernel
    availability matrix and the kernels' last dispatched designs."""
    from .ops import dispatch_report
    ops = _probe_ops()
    return {"env": env_fingerprint(), "ops": ops,
            "dispatch": dispatch_report()}


def debug_report():
    env = env_fingerprint()
    rows = [
        ("deeperspeed_tpu_torch version", env["deeperspeed_tpu_torch"]),
        ("torch version", env["torch"]),
        ("torch cuda version", env["cuda"]),
        ("numpy version", env["numpy"]),
        ("device count", env["device_count"]),
        ("device name", env["device_name"]),
        ("compute capability", env["capability"]),
        ("kernel library", (env["build"] or {}).get("path")),
    ]
    print("-" * 64)
    print("DeeperSpeed (PyTorch/CUDA) general environment info:")
    for name, value in rows:
        print(f"{name} ................ {value}")
    print("-" * 64)
    return rows


def main(argv=None):
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--json" in argv:
        # machine-readable mode: nothing else on stdout
        import json
        print(json.dumps(json_report(), indent=2, default=str))
        return 0
    op_report()
    debug_report()
    return 0


def cli_main():
    main()


if __name__ == "__main__":
    main()
