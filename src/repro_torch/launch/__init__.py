"""Launchers of the port: the serve and train entry points, the meshes
and the multi-process bootstrap."""
