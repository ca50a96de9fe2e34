"""Each traffic mix's operator: its draw from the seed, the
measurement, the program's operator and the reference's, one file an
operator, named by the mix's "operator"."""
