"""Platform descriptions of the port: XML loader (simgrid.dtd compatible)
and units."""
