"""Serving simulation on the PyTorch/CUDA port: the paper's deployment loop
(Algorithm 1).

    PYTHONPATH=src python examples/torch_serve_8k.py --frames 4 --hw 96
    PYTHONPATH=src python examples/torch_serve_8k.py --frames 8 --hw 96 \\
        --dispatch fused --inflight 2
    PYTHONPATH=src python examples/torch_serve_8k.py --frames 4 --hw 96 --quant int8
    PYTHONPATH=src python examples/torch_serve_8k.py --device cpu --frames 2 \\
        --hw 48 --scale 2

Streams synthetic frames through the port's ``SREngine`` (built by the
launcher with ``SREngine.from_checkpoint``): per-frame edge scores,
resource-adaptive thresholds, per-subnet batched execution, overlap and
average, and a Table-XI-style summary. Takes every flag of
``repro_torch.launch.serve`` (--ckpt, --budget, --backend, --deadline-ms,
--shards, --quant, --dispatch, --inflight, --device). ``--dispatch fused``
serves each frame as one CUDA graph replay; ``--inflight 2`` keeps two
frames in flight. Runs on the card unless ``--device cpu`` is given.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
