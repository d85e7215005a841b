from repro_torch.checkpoint.async_ckpt import AsyncCheckpointer
from repro_torch.checkpoint.disk import DiskCheckpointStore
from repro_torch.checkpoint.memory import MemoryCheckpointStore
from repro_torch.checkpoint.reshard import (flatten_tree, restore_from_host,
                                            snapshot_to_host,
                                            surviving_devices, tree_path_keys,
                                            unflatten_tree)

__all__ = ["AsyncCheckpointer", "DiskCheckpointStore", "MemoryCheckpointStore",
           "flatten_tree", "restore_from_host", "snapshot_to_host",
           "surviving_devices", "tree_path_keys", "unflatten_tree"]
