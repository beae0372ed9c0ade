"""Traffic: frozen copies of the port's schedule generator and open-loop
replay, and the mixes (``mixes/<traffic>.json``) they read."""
