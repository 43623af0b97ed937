from neuralmelting_tpu_torch.neural.scalers import get_scaler  # noqa: F401
from neuralmelting_tpu_torch.neural.models import PhaseCNN, PhaseMLP  # noqa: F401
from neuralmelting_tpu_torch.neural.train import train_classifier  # noqa: F401
from neuralmelting_tpu_torch.neural.melt import fit_melting_temperature  # noqa: F401
