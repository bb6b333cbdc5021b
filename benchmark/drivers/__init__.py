"""One module a kind of traffic (a traffic file's `driver`): `run(cell, t0)`."""
