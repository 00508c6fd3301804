"""Image metrics (PSNR, SSIM, L1, L2, the LPIPS proxy) and the
prediction-folder evaluation suite."""
