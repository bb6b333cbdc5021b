"""Tools of the port: the FiLM-SIREN kernel study (`bench_film_kernel`,
`time_study_designs`) and the tools of the JAX package that import jax
(`geometry`, `geoloss`, `voxel_render`, `pcl2voxel`, `blender.fixture`'s
render). The JAX package's other tools import only numpy and run as they
are."""
