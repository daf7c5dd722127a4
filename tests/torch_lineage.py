"""The committed walking lineage carried from the JAX package into the port.

    JAX_PLATFORMS=cpu python tests/torch_lineage.py

reads the orbax slim checkpoint ``checkpoints/t1_dh_stand/<run>/model_71000``
(needs JAX and orbax), turns it into the port's slim payload with
``utils.checkpoint.from_jax_slim`` and writes
``checkpoints_torch/t1_dh_stand/<run>/model_71000.pt``, with the run's
``config.json`` and the last :data:`TAIL_ROWS` rows of its ``metrics.csv``
(the whole log is 50 MB).  ``tests/test_torch_checkpoint.py`` holds the
committed file to the orbax checkpoint leaf for leaf.
"""
import os
import shutil
import sys

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

RUN = "Aug21_19-21-52_probe_s21"
ITERATION = 71000
JAX_RUN_DIR = os.path.join(ROOT, "checkpoints", "t1_dh_stand", RUN)
JAX_CKPT = os.path.join(JAX_RUN_DIR, f"model_{ITERATION}")
PORT_RUN_DIR = os.path.join(ROOT, "checkpoints_torch", "t1_dh_stand", RUN)
PORT_CKPT = os.path.join(PORT_RUN_DIR, f"model_{ITERATION}.pt")
TAIL_ROWS = 500


def restore_orbax(path: str = JAX_CKPT):
    """The orbax checkpoint at ``path`` as nested dicts of numpy arrays (the
    way ``tools/slim_checkpoint.py`` restores it)."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(path).item_metadata.tree
    args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta)
    return ckptr.restore(path, restore_args=args)


def main():
    from ti5_isaacgym_tpu_torch.utils.checkpoint import from_jax_slim, save

    payload = from_jax_slim(restore_orbax())
    save(payload, PORT_CKPT)
    shutil.copyfile(os.path.join(JAX_RUN_DIR, "config.json"),
                    os.path.join(PORT_RUN_DIR, "config.json"))
    with open(os.path.join(JAX_RUN_DIR, "metrics.csv")) as f:
        header = f.readline()
        tail = f.readlines()[-TAIL_ROWS:]
    with open(os.path.join(PORT_RUN_DIR, "metrics.csv"), "w") as f:
        f.write(header)
        f.writelines(tail)
    print(f"wrote {PORT_CKPT} ({os.path.getsize(PORT_CKPT)} B), config.json and the last "
          f"{len(tail)} rows of metrics.csv")


if __name__ == "__main__":
    main()
