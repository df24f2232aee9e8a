from . import manifest  # noqa: F401
from .async_manager import AsyncCheckpointManager  # noqa: F401
from .checkpointing import (load_checkpoint,  # noqa: F401
                            load_module_checkpoint, save_checkpoint,
                            snapshot_checkpoint, write_and_commit)
