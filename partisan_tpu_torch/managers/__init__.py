"""Peer-service managers (port of ``partisan_tpu/managers``): full mesh,
HyParView, SCAMP v1/v2, client-server and static."""


def get(name: str):
    """Resolve ``Config.peer_service_manager`` to a manager."""
    if name == "fullmesh":
        from partisan_tpu_torch.managers import fullmesh
        return fullmesh.FullMesh()
    if name == "hyparview":
        from partisan_tpu_torch.managers import hyparview
        return hyparview.HyParView()
    if name in ("scamp_v1", "scamp_v2"):
        from partisan_tpu_torch.managers import scamp
        return scamp.Scamp(version=int(name[-1]))
    if name == "client_server":
        from partisan_tpu_torch.managers import client_server
        return client_server.ClientServer()
    if name == "static":
        from partisan_tpu_torch.managers import static
        return static.Static()
    raise KeyError(
        f"unknown peer_service_manager {name!r}: fullmesh|hyparview|"
        f"scamp_v1|scamp_v2|client_server|static")


def neighbor_width(cfg) -> int:
    """Static width K of the manager's ``neighbors`` arrays."""
    name = cfg.peer_service_manager
    if name == "hyparview":
        return cfg.hyparview.active_max
    if name in ("scamp_v1", "scamp_v2"):
        return cfg.scamp.partial_max
    return cfg.n_nodes  # fullmesh / client_server / static: dense rows
