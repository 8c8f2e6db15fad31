"""Peer-service managers (port of ``partisan_tpu/managers``): full mesh
and HyParView."""


def get(name: str):
    """Resolve ``Config.peer_service_manager`` to a manager."""
    if name == "fullmesh":
        from partisan_tpu_torch.managers import fullmesh
        return fullmesh.FullMesh()
    if name == "hyparview":
        from partisan_tpu_torch.managers import hyparview
        return hyparview.HyParView()
    raise NotImplementedError(f"manager {name!r} is not ported")


def neighbor_width(cfg) -> int:
    """Static width K of the manager's ``neighbors`` arrays."""
    if cfg.peer_service_manager == "hyparview":
        return cfg.hyparview.active_max
    if cfg.peer_service_manager == "fullmesh":
        return cfg.n_nodes
    raise NotImplementedError(
        f"manager {cfg.peer_service_manager!r} is not ported")
