from visitron_torch.sim.simulator import GraphSimulator, Location, SimState, make_simulator

__all__ = ["GraphSimulator", "Location", "SimState", "make_simulator"]
