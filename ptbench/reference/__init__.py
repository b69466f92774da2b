"""The benchmark's plain reference: its own loader of the scene files
(`loader`), PNG decoder (`png`), spectral arithmetic (`spectra`) and a
path tracer in plain PyTorch (`pt`). Nothing here imports the program
under test."""
