"""Resumable runs: npz pytree checkpoints (``io``) and the simulator's
complete state (``carry``), in the reference's file format."""
from repro_torch.checkpoint.io import (load_pytree, save_pytree,  # noqa: F401
                                       latest_checkpoint, prune_checkpoints,
                                       save_round, restore_round)
from repro_torch.checkpoint.carry import (config_fingerprint,  # noqa: F401
                                          host_state, restore_checkpoint,
                                          save_checkpoint)
