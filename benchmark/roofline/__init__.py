"""Operations and bytes a kernel launch needs, one file a kernel, counted
from the launch's shapes and masks: each input byte read once, each
output byte written once, whatever the kernel reads again."""
