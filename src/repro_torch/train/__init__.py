"""Supernet training (twin of ``repro.train``): optimizers, losses, the
sampled-subnet trainer and the perceptual (GAN) phase."""
