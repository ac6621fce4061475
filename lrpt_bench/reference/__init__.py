"""The plain reference of the demodulator: NumPy and PyTorch on the CPU.

Frozen copies of the receive chain's definition (the RRC taps, the
polyphase matched filter, the per-fire recurrence of the timing gate, AGC,
Costas PLL, lock detector and M&M retiming, the int8 quantizer and the .s
writer's lock gate), written from the configuration alone. It imports
nothing of meteor_demod_tpu_torch, jax or meteor_demod_tpu, and takes no
weights, tables or state that the program made.
"""
