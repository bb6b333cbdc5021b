"""Plain PyTorch references, one file a configuration, found by the
configuration's name; `plain.py` holds the modules they share. Nothing here
imports the program."""
