"""Example launcher for the PyTorch port (the reference ships
`runaudian.py:1-10` with the same shape): open a recording with a
1-15 kHz band-pass preset on the CUDA card."""

from audian_torch.cli.audian import main

if __name__ == "__main__":
    main(["-f", "1000", "-l", "15000", "data/recording.wav"])
