from visitron_torch.graph.nav_graph import NavGraph, load_nav_graphs

__all__ = ["NavGraph", "load_nav_graphs"]
