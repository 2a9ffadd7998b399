"""The port's runnable examples (examples/ beside the package stays the JAX
package's)."""

import subprocess

import torch


def card_line(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (the
    first card's line), where a JAX record names its backend; "cpu" for a
    CPU device."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
