"""End-to-end training on the PyTorch/CUDA port: the paper's PSNR phase
(scaled down) with checkpoints, then PSNR_Y of the EMA weights per subnet.

    PYTHONPATH=src python examples/torch_train_essr.py --steps 300
    PYTHONPATH=src python examples/torch_train_essr.py --steps 300 --gan-steps 50
    PYTHONPATH=src python examples/torch_train_essr.py --steps 20 --ckpt-dir ck
    PYTHONPATH=src python examples/torch_serve_8k.py --ckpt ck
    PYTHONPATH=src python examples/torch_train_essr.py --device cpu --steps 3 \\
        --batch 2 --patch 8 --scale 2

The full recipe (Lamb 3e-3 cosine, batch 256, 200K iterations, EMA 0.999,
MAC-proportional subnet sampling) lives in ``repro_torch.train.trainer`` and
``repro_torch.launch.train``, whose flags this takes; this example defaults
to 300 steps. Runs on the card unless ``--device cpu`` is given.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import train


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--steps" not in argv:
        argv += ["--steps", "300"]
    train.main(argv)


if __name__ == "__main__":
    main()
