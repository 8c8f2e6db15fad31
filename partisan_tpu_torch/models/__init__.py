"""Protocol models layered over a manager (port of
``partisan_tpu/models/``): anti-entropy, Plumtree, direct mail, rumor
mongering, the 2PC/3PC/CTP commit engine, Alsberg-Day primary/backup,
Paxos, and the chat/echo apps."""

from partisan_tpu_torch.models.anti_entropy import AntiEntropy  # noqa: F401
from partisan_tpu_torch.models.plumtree import Plumtree  # noqa: F401
from partisan_tpu_torch.models.direct_mail import DirectMail  # noqa: F401
from partisan_tpu_torch.models.rumor_mongering import (  # noqa: F401
    RumorMongering)
from partisan_tpu_torch.models.commit import CommitProtocol  # noqa: F401
from partisan_tpu_torch.models.alsberg_day import AlsbergDay  # noqa: F401
