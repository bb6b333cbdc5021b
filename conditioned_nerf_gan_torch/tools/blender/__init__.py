"""The bpy-free parts of the offline Blender pipeline the port runs: the
camera math and the exporter fixture's render."""
