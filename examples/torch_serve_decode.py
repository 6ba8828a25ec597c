"""Batched LM serving with a KV cache on the PyTorch port (smoke-size
granite-8b), reading its decode weights through the parameter service's
read tier: the model's parameters are hosted as one service job and
pulled, bit for bit, from a two-replica ``ReplicaSet`` before decoding.
The torch counterpart of ``examples/serve_decode.py``; it calls
``repro_torch.launch.serve`` in this process.

Run: PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""

import argparse

from repro_torch.launch import serve


def main(argv=None) -> dict:
    """Returns ``serve.main``'s result (tokens, logits, cache, seconds)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve.main(
        ["--arch", "granite-8b", "--smoke", "--batch", "4", "--prompt-len",
         "8", "--gen", "24", "--temperature", "0.8", "--replicas", "2"]
        + ([] if args.device is None else ["--device", args.device]))


if __name__ == "__main__":
    main()
