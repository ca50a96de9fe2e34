"""Array ops of the port: the Haar DWT kernel and the orthonormal transforms."""
