"""Shared example plumbing: CPU forcing + pretrained flag."""

import argparse
import os


def setup(description: str) -> argparse.Namespace:
    if os.environ.get("EXAMPLES_CPU") == "1":
        import jax

        jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--pretrained", action="store_true",
                    help="download + convert official weights (needs egress); "
                         "default: random weights, demonstrating the API only")
    return ap.parse_args()
