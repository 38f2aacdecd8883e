"""Serving layer of the port: engines, the KV wire, the page pool and the
prefix index (the gateway and transport come in a later slice)."""
