from acados_tpu_torch.models.chain_mass import (chain_mass_ode,
                                                chain_steady_state,
                                                export_chain_mass_model,
                                                make_chain_mass_ocp)
from acados_tpu_torch.models.pendulum import (export_pendulum_model,
                                              make_pendulum_ocp, pendulum_ode)
from acados_tpu_torch.models.quadrotor import (export_quadrotor_model,
                                               make_quadrotor_ocp,
                                               quadrotor_ode)
from acados_tpu_torch.models.race_car import (make_race_car_ocp,
                                              race_car_constraints,
                                              race_car_ode)

__all__ = [
    "chain_mass_ode", "chain_steady_state", "export_chain_mass_model",
    "make_chain_mass_ocp", "export_pendulum_model", "make_pendulum_ocp",
    "pendulum_ode", "export_quadrotor_model", "make_quadrotor_ocp",
    "quadrotor_ode", "make_race_car_ocp", "race_car_ode",
    "race_car_constraints",
]
