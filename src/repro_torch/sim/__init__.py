"""The IoV simulator of the port: the round under every engine it runs,
the channel and mobility models, trace replay and the scenario presets."""
from repro_torch.sim.channel import ChannelModel, ChannelConfig  # noqa: F401
from repro_torch.sim.mobility_model import (MobilityModel,  # noqa: F401
                                            MobilitySimConfig, RSU)
from repro_torch.sim.scenarios import (SCENARIOS, Scenario,  # noqa: F401
                                       build_config, build_sim,
                                       get_scenario, list_scenarios)
from repro_torch.sim.simulator import IoVSimulator, SimConfig  # noqa: F401
from repro_torch.sim.trajectories import (TraceSet, build_trace,  # noqa: F401
                                          load_tdrive, synthesize)
