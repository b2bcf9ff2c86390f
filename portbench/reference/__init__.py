"""Plain torch answers, one module per schema family, named by a
configuration's "reference" key.  Nothing here imports the program."""
