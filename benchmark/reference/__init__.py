"""The benchmark's plain reference: float32 PyTorch and NumPy that compute
what the timed path must produce, with no import of the program or of JAX
(`adm.py`: the model and its denoiser's moments; `guided.py`: the
guided Heun step's mathematics; `op_<name>.py`: an operator's solve;
`lowp.py`: the control's lower precision)."""
