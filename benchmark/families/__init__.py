"""How each model family builds the program's model and sampler and the
reference's model, one file a family, named by a configuration's
"family"."""
