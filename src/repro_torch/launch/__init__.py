"""The sharded launch path: meshes, cells, collective counts, the dry run
and the launcher."""
