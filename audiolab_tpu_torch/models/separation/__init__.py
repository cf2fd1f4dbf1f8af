from audiolab_tpu_torch.models.separation.htdemucs import HTDemucs, HTDemucsConfig
from audiolab_tpu_torch.models.separation.mdx import MDXConfig, MDXNet, MDXOnnxSeparator
from audiolab_tpu_torch.models.separation.mdx23c import MDX23CConfig, TFCTDFNetV3
from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig

__all__ = ["BSRoformer", "RoformerConfig", "MDXNet", "MDXConfig", "MDXOnnxSeparator",
           "MDX23CConfig", "TFCTDFNetV3", "HTDemucs", "HTDemucsConfig"]
