"""The LM side: the port of ``repro.models.lm`` (attention, FFN/MoE and the
dynamic-width FFN, Mamba-1/2, the decoder-only stack and the enc-dec stack),
serving only: prefill, decode and the loss value."""
