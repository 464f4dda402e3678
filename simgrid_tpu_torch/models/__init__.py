"""Resource models of the port (the SURF equivalent): host, cpu, network."""
