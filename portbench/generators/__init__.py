"""Table generators, one module per schema family, named by a
configuration's "generator" key."""
