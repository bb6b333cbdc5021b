"""Tools of the port: the FiLM-SIREN kernel study (`bench_film_kernel`)."""
